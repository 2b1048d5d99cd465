// Prime-field and quadratic-extension arithmetic shared by every kernel of
// the port (the CUDA counterpart of the _mul_body/_fadd/_fsub/_F/_F2
// helpers in libsnark_tpu/ops/pallas_fp.py).
//
// Interface layout (what the wrappers pass): 16-bit limbs in int32 words,
// limbs leading, so limb k of element t of a length-L batch is at k*L + t
// and neighbouring threads read neighbouring words. In registers an element
// is NW words of 32 bits (a template parameter: 8 for a 256-bit modulus,
// 12 for a 384-bit one; the interface has NL = 2*NW limbs); products are
// 64-bit. R = 2^(32*NW) is the JAX package's 2^(16*N), so the Montgomery
// form is the same; only the REDC constant differs: n0inv = -p^-1 mod 2^32
// here (mod 2^16 in the JAX code). The product (fp_mul, a carry chain)
// needs p < R/2, which every curve of the repository meets and
// ops/cuda_lib.make_mod checks; fp_reduce_once takes a carry word beside the
// NW words for fp_add.
//
// Every value a function returns is canonical (< p), so any correct
// formula gives the JAX package's bits exactly.
//
// Every function is a template over NW. Each source instantiates its
// kernels for NW = 8 and NW = 12 and its C entries take the width as their
// first argument (nw); one more width is one more case in each source's
// launch switch.
#pragma once
#include <stdint.h>

template <int NW>
struct Mod {
  uint32_t p[NW];     // modulus
  uint32_t one[NW];   // R mod p (Montgomery one)
  uint32_t n0inv;     // -p^-1 mod 2^32
  int32_t beta_small; // |Fp2 non-residue| (<= 8), 0 for plain Fp
  int32_t beta_neg;   // non-residue is -beta_small
};

template <int NW>
struct Fp {
  uint32_t w[NW];
};

// ---------------------------------------------------------------- load/store
template <int NW>
__device__ __forceinline__ Fp<NW> fp_load(const int32_t* __restrict__ base,
                                          int64_t stride, int64_t idx) {
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t lo = (uint32_t)base[(2 * k) * stride + idx];
    uint32_t hi = (uint32_t)base[(2 * k + 1) * stride + idx];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

template <int NW>
__device__ __forceinline__ void fp_store(int32_t* __restrict__ base,
                                         int64_t stride, int64_t idx,
                                         const Fp<NW>& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    base[(2 * k) * stride + idx] = (int32_t)(a.w[k] & 0xFFFFu);
    base[(2 * k + 1) * stride + idx] = (int32_t)(a.w[k] >> 16);
  }
}

// ------------------------------------------------------------------ helpers
template <int NW>
__device__ __forceinline__ Fp<NW> fp_zero() {
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = 0;
  return r;
}

template <int NW>
__device__ __forceinline__ Fp<NW> fp_from(const uint32_t* w) {
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = w[k];
  return r;
}

template <int NW>
__device__ __forceinline__ bool fp_is_zero(const Fp<NW>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) acc |= a.w[k];
  return acc == 0;
}

template <int NW>
__device__ __forceinline__ Fp<NW> fp_select(bool c, const Fp<NW>& a,
                                            const Fp<NW>& b) {
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = c ? a.w[k] : b.w[k];
  return r;
}

// r = a - p if a >= p (a < 2p, with an extra top word `top`)
template <int NW>
__device__ __forceinline__ Fp<NW> fp_reduce_once(const Fp<NW>& a, uint32_t top,
                                                 const Mod<NW>& M) {
  Fp<NW> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint64_t t = (uint64_t)a.w[k] - M.p[k] - borrow;
    d.w[k] = (uint32_t)t;
    borrow = (t >> 63) & 1;
  }
  // a >= p  <=>  no borrow out of the NW words, or a carry word on top
  bool ge = (top != 0) || (borrow == 0);
  return fp_select<NW>(ge, d, a);
}

// --------------------------------------------------------------- arithmetic
template <int NW>
__device__ __forceinline__ Fp<NW> fp_add(const Fp<NW>& a, const Fp<NW>& b,
                                         const Mod<NW>& M) {
  Fp<NW> s;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    s.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
  return fp_reduce_once<NW>(s, (uint32_t)carry, M);
}

template <int NW>
__device__ __forceinline__ Fp<NW> fp_sub(const Fp<NW>& a, const Fp<NW>& b,
                                         const Mod<NW>& M) {
  Fp<NW> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint64_t t = (uint64_t)a.w[k] - b.w[k] - borrow;
    d.w[k] = (uint32_t)t;
    borrow = (t >> 63) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint64_t t = (uint64_t)d.w[k] + M.p[k] + carry;
      d.w[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return d;
}

template <int NW>
__device__ __forceinline__ Fp<NW> fp_neg(const Fp<NW>& a, const Mod<NW>& M) {
  return fp_sub<NW>(fp_zero<NW>(), a, M);
}

template <int NW>
__device__ __forceinline__ Fp<NW> fp_dbl(const Fp<NW>& a, const Mod<NW>& M) {
  return fp_add<NW>(a, a, M);
}

// ------------------------------------------------- carry-chain product
// The Montgomery product as PTX carry chains (mad.lo.cc, madc.hi.cc,
// addc) over two column accumulators. "even" takes the products of the
// even words a[0], a[2], ..: lo at column j and hi at j + 1, disjoint
// pairs, so a row of them is one unbroken chain of multiply-adds and no
// wide product needs separate adds for its carries; "odd" takes those of
// the odd words, one column up. The running value is even + 2^32 odd.
// Each round adds a b_i and m p (m zeroes the low word) and divides by
// 2^32 by swapping the two roles: the accumulator whose low word is zero
// moves down two words into the other role (rshift) while the round's
// products go into it. Needs p < R/2: the value then stays below 2p, and
// the carries the code drops (out of each odd chain) are zero.
// The carry flag lives between consecutive asm statements; they are
// volatile so that the compiler keeps their order, and nothing between
// them writes the flag (only .cc instructions do, and only these).
namespace chain {

template <int NW>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a,
                                      uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = __umulhi(a[j], bi);
  }
}

// acc += a[j] bi at columns (j, j + 1), j even; carry out in the flag
template <int NW>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a,
                                       uint32_t bi) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(acc[0]), "+r"(acc[1]) : "r"(a[0]), "r"(bi));
#pragma unroll
  for (int j = 2; j < NW; j += 2)
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
                 : "+r"(acc[j]), "+r"(acc[j + 1]) : "r"(a[j]), "r"(bi));
}

// acc <- (acc >> 2 words) + a[j] bi at columns (j, j + 1), carry in from
// the flag; the top word takes no carry out (hi(a b) + 1 < 2^32)
template <int NW>
__device__ __forceinline__ void madc_n_rshift(uint32_t* acc, const uint32_t* a,
                                              uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NW - 2; j += 2)
    asm volatile("madc.lo.cc.u32 %0, %2, %3, %4; madc.hi.cc.u32 %1, %2, %3, %5;"
                 : "=r"(acc[j]), "=r"(acc[j + 1])
                 : "r"(a[j]), "r"(bi), "r"(acc[j + 2]), "r"(acc[j + 3]));
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0; madc.hi.u32 %1, %2, %3, 0;"
               : "=r"(acc[NW - 2]), "=r"(acc[NW - 1]) : "r"(a[NW - 2]), "r"(bi));
}

// One round: even + 2^32 odd (+)= a bi, then + m p with m = even[0] n0inv,
// which zeroes even[0]. On entry (after the first round) odd holds the
// previous round's zeroed accumulator and even its other one.
template <int NW, bool FIRST>
__device__ __forceinline__ void mad_n_redc(uint32_t* even, uint32_t* odd,
                                           const uint32_t* a, uint32_t bi,
                                           const Mod<NW>& M) {
  if (FIRST) {
    mul_n<NW>(odd, a + 1, bi);
    mul_n<NW>(even, a, bi);
  } else {
    asm volatile("add.cc.u32 %0, %0, %1;" : "+r"(even[0]) : "r"(odd[1]));
    madc_n_rshift<NW>(odd, a + 1, bi);
    cmad_n<NW>(even, a, bi);
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[NW - 1]));
  }
  uint32_t mi = even[0] * M.n0inv;
  cmad_n<NW>(odd, M.p + 1, mi);
  cmad_n<NW>(even, M.p, mi);
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(odd[NW - 1]));
}

}  // namespace chain

// Products of LSN_CHAIN_ROLL_NW words or more (every width, by default)
// run the rounds after the first two in a loop of two rounds that is not
// unrolled; the b words rotate down two places an iteration, so every
// index stays static. Unrolled, ptxas overlaps many rounds and, out of
// carry predicates, keeps carries as bits of a register (at NW = 12 the
// product took 822 instructions, 413 of them LOP3 / P2R / ISETP moving
// carries); rolled, G1 add at 24 limbs ran 1.38x and bucket_reduce 1.29x
// faster on an H100, with fewer registers (bucket_reduce 168 -> 149), and
// at 16 limbs 0-10 % faster (scripts/sweep_launch_bounds.py, which sets
// it with -D).
#ifndef LSN_CHAIN_ROLL_NW
#define LSN_CHAIN_ROLL_NW 8
#endif

// a*b*2^(-32 NW) mod p (inputs canonical, p < R/2), canonical out; ROLLED:
// the loop above
template <int NW, bool ROLLED>
__device__ __forceinline__ Fp<NW> fp_mul_chain(const Fp<NW>& a,
                                               const Fp<NW>& b,
                                               const Mod<NW>& M) {
  static_assert(NW % 2 == 0, "the carry-chain product pairs words");
  uint32_t even[NW], odd[NW];
  chain::mad_n_redc<NW, true>(even, odd, a.w, b.w[0], M);
  chain::mad_n_redc<NW, false>(odd, even, a.w, b.w[1], M);
  if constexpr (ROLLED) {
    uint32_t bw[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) bw[k] = b.w[k];
#pragma unroll 1
    for (int i = 2; i < NW; i += 2) {
#pragma unroll
      for (int k = 0; k + 2 < NW; ++k) bw[k] = bw[k + 2];
      chain::mad_n_redc<NW, false>(even, odd, a.w, bw[0], M);
      chain::mad_n_redc<NW, false>(odd, even, a.w, bw[1], M);
    }
  } else {
#pragma unroll
    for (int i = 2; i < NW; i += 2) {
      chain::mad_n_redc<NW, false>(even, odd, a.w, b.w[i], M);
      chain::mad_n_redc<NW, false>(odd, even, a.w, b.w[i + 1], M);
    }
  }
  // the value is even + odd / 2^32 (odd[0] is zero), below 2p
  Fp<NW> r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r.w[0]) : "r"(even[0]), "r"(odd[1]));
#pragma unroll
  for (int j = 1; j < NW - 1; ++j)
    asm volatile("addc.cc.u32 %0, %1, %2;"
                 : "=r"(r.w[j]) : "r"(even[j]), "r"(odd[j + 1]));
  asm volatile("addc.u32 %0, %1, 0;" : "=r"(r.w[NW - 1]) : "r"(even[NW - 1]));
  return fp_reduce_once<NW>(r, 0, M);
}

// The field product of every kernel. CIOS, the body it replaced (583
// instructions at NW = 8, 1260 at NW = 12), stays in csrc/probe.cu as
// variant 0 of the CIOS probe, beside both forms of the chain.
template <int NW>
__device__ __forceinline__ Fp<NW> fp_mul(const Fp<NW>& a, const Fp<NW>& b,
                                         const Mod<NW>& M) {
  return fp_mul_chain<NW, (NW >= LSN_CHAIN_ROLL_NW)>(a, b, M);
}

// The same product as a called function: one copy per kernel instead of
// one per call site. The Fp2 group law (50+ base products per kernel) uses
// it: inlined, those kernels hit the 255-register cap and spill; called,
// they ran about 1.5-2x faster on an H100 and the build took half the
// time. G1 and mont_mul keep the inlined body, which is faster there
// (called, mont_mul needs a stack frame and ran about 3x slower).
template <int NW>
__device__ __noinline__ Fp<NW> fp_mul_call(const Fp<NW>& a, const Fp<NW>& b,
                                           const Mod<NW>& M) {
  return fp_mul<NW>(a, b, M);
}

// ------------------------------------------------ extension-generic element
// E = 1: Fp; E = 2: Fp2 = Fp[s]/(s^2 - beta), beta = (-1)^beta_neg *
// beta_small. Coefficient c sits in field rows [c*NL, (c+1)*NL), NL = 2 NW,
// of a (E*NL, L) array, the JAX package's (2, N, L) -> (2N, L) flattening.
template <int NW, int E>
struct Fe {
  Fp<NW> c[E];
};

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_load(const int32_t* base,
                                             int64_t stride, int64_t idx) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c)
    r.c[c] = fp_load<NW>(base + (int64_t)c * 2 * NW * stride, stride, idx);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ void fe_store(int32_t* base, int64_t stride,
                                         int64_t idx, const Fe<NW, E>& a) {
#pragma unroll
  for (int c = 0; c < E; ++c)
    fp_store<NW>(base + (int64_t)c * 2 * NW * stride, stride, idx, a.c[c]);
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_zero() {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_zero<NW>();
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_one(const Mod<NW>& M) {
  Fe<NW, E> r = fe_zero<NW, E>();
  r.c[0] = fp_from<NW>(M.one);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW, E>& a) {
  bool z = true;
#pragma unroll
  for (int c = 0; c < E; ++c) z = z && fp_is_zero<NW>(a.c[c]);
  return z;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_select(bool s, const Fe<NW, E>& a,
                                               const Fe<NW, E>& b) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_select<NW>(s, a.c[c], b.c[c]);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_add(const Fe<NW, E>& a,
                                            const Fe<NW, E>& b,
                                            const Mod<NW>& M) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_add<NW>(a.c[c], b.c[c], M);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_sub(const Fe<NW, E>& a,
                                            const Fe<NW, E>& b,
                                            const Mod<NW>& M) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_sub<NW>(a.c[c], b.c[c], M);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_neg(const Fe<NW, E>& a,
                                            const Mod<NW>& M) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_neg<NW>(a.c[c], M);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_dbl(const Fe<NW, E>& a,
                                            const Mod<NW>& M) {
  return fe_add<NW, E>(a, a, M);
}

// a * beta in the base field: addition chain on |beta|, then the sign
template <int NW>
__device__ __forceinline__ Fp<NW> fp_mul_by_nonresidue(const Fp<NW>& a,
                                                       const Mod<NW>& M) {
  Fp<NW> out = a;
  for (int k = 1; k < M.beta_small; ++k) out = fp_add<NW>(out, a, M);
  return M.beta_neg ? fp_neg<NW>(out, M) : out;
}

template <int NW>
__device__ __forceinline__ Fe<NW, 1> fe_mul(const Fe<NW, 1>& a,
                                            const Fe<NW, 1>& b,
                                            const Mod<NW>& M) {
  Fe<NW, 1> r;
  r.c[0] = fp_mul<NW>(a.c[0], b.c[0], M);
  return r;
}

// Karatsuba: v0 = a0 b0, v1 = a1 b1, t = (a0 + a1)(b0 + b1);
// c0 = v0 + beta v1, c1 = t - v0 - v1
template <int NW>
__device__ __forceinline__ Fe<NW, 2> fe_mul(const Fe<NW, 2>& a,
                                            const Fe<NW, 2>& b,
                                            const Mod<NW>& M) {
  Fp<NW> v0 = fp_mul_call<NW>(a.c[0], b.c[0], M);
  Fp<NW> v1 = fp_mul_call<NW>(a.c[1], b.c[1], M);
  Fp<NW> t = fp_mul_call<NW>(fp_add<NW>(a.c[0], a.c[1], M),
                             fp_add<NW>(b.c[0], b.c[1], M), M);
  Fe<NW, 2> r;
  r.c[0] = fp_add<NW>(v0, fp_mul_by_nonresidue<NW>(v1, M), M);
  r.c[1] = fp_sub<NW>(t, fp_add<NW>(v0, v1, M), M);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_sqr(const Fe<NW, E>& a,
                                            const Mod<NW>& M) {
  return fe_mul(a, a, M);
}
