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
// here (mod 2^16 in the JAX code). Nothing below assumes that p fills its
// top word: CIOS keeps an (NW+2)-word accumulator, its result is < 2p for
// any p < R, and fp_reduce_once takes the carry word beside the NW words.
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

// row-major load: the 2*NW limbs of one element are contiguous
template <int NW>
__device__ __forceinline__ Fp<NW> fp_load_row(const int32_t* __restrict__ row) {
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = ((uint32_t)row[2 * k] & 0xFFFFu) | ((uint32_t)row[2 * k + 1] << 16);
  return r;
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

// CIOS Montgomery product a*b*2^(-32 NW) mod p (inputs canonical).
template <int NW>
__device__ __forceinline__ Fp<NW> fp_mul(const Fp<NW>& a, const Fp<NW>& b,
                                         const Mod<NW>& M) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + C;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M.n0inv;
    s = (uint64_t)m * M.p[0] + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * M.p[j] + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[NW] + C;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
  return fp_reduce_once<NW>(r, t[NW], M);
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
__device__ __forceinline__ Fe<NW, E> fe_load_row(const int32_t* row) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = fp_load_row<NW>(row + c * 2 * NW);
  return r;
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
