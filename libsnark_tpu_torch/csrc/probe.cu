// Two measurement kernels for the card (no part of the proving path):
//
// rate_kernel: the card's counterpart of the TPU probe
// scripts/probe_vpu_ops.py:49. Every thread runs CHAINS chains of K
// dependent steps of one 32-bit operation, so the pipes stay full and the
// time of a launch is steps / rate. The operations are the ones the field
// code is made of: mul.lo, mad.lo, mad.hi, the 32x32->64 multiply-add
// (three forms, below), a 64-bit add (add.cc + addc), shift+and, and an f32
// multiply as the yardstick against the data sheet.
//
// The wide multiply-add is the instruction every product bound rests on,
// so the probe has to issue it and nothing else. Written as PTX mad.wide,
// ptxas (sm_90a) does not make it one instruction: it emits IMAD.WIDE.U32
// with a zero addend and adds the old pair with IADD3 and IADD3.X, whatever
// chain the multiplicand comes from (the chain's own low word, a
// neighbour's, rotations over 2, 4 and 8 chains were tried). Written as
// the carry-chain pair mad.lo.cc + madc.hi inside one asm statement on a
// 64-bit register, the form field.cuh's product is made of, it becomes one
// IMAD.WIDE.U32 with the 64-bit addend inside. So:
//  - mad_wide: w[c] = lo(w[c ^ 1]) * y[c] + w[c], chains in pairs updated
//    in order (the even chain reads its partner's old value, the odd one
//    the new), in the carry-chain form: one IMAD.WIDE.U32 a step and no add
//    (probes.single_wide_mad_loop checks the listing). Of the recurrences
//    tried in that form, the pairs ran fastest on an H100.
//  - mad_wide_split: w[c] = lo(w[c]) * y[c] + w[c] as PTX mad.wide, the
//    body this probe had before and what C code gets from the toolchain
//    (one IMAD.WIDE.U32, one IADD3 and half an IADD3.X a step).
//  - mad_cc: one row of field.cuh's product, w[c] += x[c] * y[c] + carry
//    over the CHAINS pairs as one mad.lo.cc / madc.hi.cc carry chain a step
//    (x, y fixed, the carry out of the last pair dropped): IMAD.WIDE.U32
//    and IMAD.WIDE.U32.X with the carries in predicates.
// Bound: the instructions of a step in the main loop's machine code
// (probes.sass_loops), at the lane rate; it moves 12 bytes per chain
// whatever K is.
//
// cios_kernel: the counterpart of scripts/probe_cios.py:98. K chained
// Montgomery products x <- x * b per lane in four bodies: CIOS (variant
// 0, the kernels' product until the carry chain replaced it), a separated
// operand-scanning product (variant 1: the full 2 NW-word product by rows
// of multiply-adds, then NW reduction rows with one running top carry) and
// the carry-chain product of field.cuh (PTX mad.lo.cc / madc.hi.cc chains
// over even and odd column accumulators) with its rounds unrolled (variant
// 2) and in a loop of two rounds (variant 3); fp_mul takes one of the two
// by the width; and the lane-split product of field.cuh (variant 4), one
// element a group of GS lanes (8 at NW = 8, 16 at NW = 12, 32 at NW = 24),
// the product of horner_combine's lane groups; at NW = 24 only variants
// 2-4 are built, for the latency of one dependent product. All return canonical values, so each is
// exact against the plain Montgomery product. Bound: 2 NW^2 + NW wide
// multiply-adds per product. Launched over one element (L = 1), each
// variant's time over K is the latency of one dependent product, the
// yardstick of horner_combine's latency bound.
#include "field.cuh"

#define CHAINS 8

enum RateOp { MUL_LO = 0, MAD_LO, MAD_HI, MAD_WIDE, ADD64, SHIFT_AND, MUL_F32,
              MAD_WIDE_SPLIT, MAD_CC };

// w += m * y (mod 2^64) as the carry-chain pair on one 64-bit register: one
// IMAD.WIDE.U32 with w as its addend
__device__ __forceinline__ void mad_wide_cc(uint64_t& w, uint32_t m,
                                            uint32_t y) {
  asm("{ .reg .u32 l, h; mov.b64 {l, h}, %0;"
      " mad.lo.cc.u32 l, %1, %2, l; madc.hi.u32 h, %1, %2, h;"
      " mov.b64 %0, {l, h}; }"
      : "+l"(w) : "r"(m), "r"(y));
}

// w[c] += x[c] y[c] + carry, c = 0 .. CHAINS - 1, as one carry chain (the
// flag lives between the volatile statements, as in field.cuh)
__device__ __forceinline__ void mad_cc_row(uint64_t* w, const uint32_t* x,
                                           const uint32_t* y) {
  asm volatile("{ .reg .u32 l, h; mov.b64 {l, h}, %0;"
               " mad.lo.cc.u32 l, %1, %2, l; madc.hi.cc.u32 h, %1, %2, h;"
               " mov.b64 %0, {l, h}; }"
               : "+l"(w[0]) : "r"(x[0]), "r"(y[0]));
#pragma unroll
  for (int c = 1; c < CHAINS - 1; ++c)
    asm volatile("{ .reg .u32 l, h; mov.b64 {l, h}, %0;"
                 " madc.lo.cc.u32 l, %1, %2, l; madc.hi.cc.u32 h, %1, %2, h;"
                 " mov.b64 %0, {l, h}; }"
                 : "+l"(w[c]) : "r"(x[c]), "r"(y[c]));
  asm volatile("{ .reg .u32 l, h; mov.b64 {l, h}, %0;"
               " madc.lo.cc.u32 l, %1, %2, l; madc.hi.u32 h, %1, %2, h;"
               " mov.b64 %0, {l, h}; }"
               : "+l"(w[CHAINS - 1]) : "r"(x[CHAINS - 1]), "r"(y[CHAINS - 1]));
}

// a, b, out: CHAINS x T words (chain c of thread t at c*T + t). The 64-bit
// ops run on w (high word zero at the start) and return lo ^ hi.
template <int OP>
__global__ void __launch_bounds__(256)
rate_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            uint32_t* __restrict__ out, int64_t T, int K) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  uint32_t x[CHAINS], y[CHAINS];
  uint64_t w[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    x[c] = a[c * T + t];
    y[c] = b[c * T + t];
    w[c] = x[c];
  }
#pragma unroll 4                 // probes.RATE_UNROLL: steps of a chain a pass
  for (int k = 0; k < K; ++k) {
    if (OP == MAD_CC) mad_cc_row(w, x, y);
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (OP == MUL_LO) x[c] = x[c] * y[c];
      if (OP == MAD_LO) x[c] = x[c] * y[c] + y[c];
      if (OP == MAD_HI) x[c] = __umulhi(x[c], y[c]) + y[c];
      if (OP == MAD_WIDE) mad_wide_cc(w[c], (uint32_t)w[c ^ 1], y[c]);
      if (OP == MAD_WIDE_SPLIT)
        asm("mad.wide.u32 %0, %1, %2, %0;"
            : "+l"(w[c]) : "r"((uint32_t)w[c]), "r"(y[c]));
      if (OP == ADD64) w[c] = w[c] + (((uint64_t)y[c] << 32) | y[c]);
      if (OP == SHIFT_AND) x[c] = ((x[c] >> 1) & y[c]) ^ y[c];
      if (OP == MUL_F32)
        x[c] = __float_as_uint(__uint_as_float(x[c]) * __uint_as_float(y[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    if (OP == MAD_WIDE || OP == ADD64 || OP == MAD_WIDE_SPLIT || OP == MAD_CC)
      x[c] = (uint32_t)w[c] ^ (uint32_t)(w[c] >> 32);
    out[c * T + t] = x[c];
  }
}

extern "C" int lsn_probe_rate(int op, const void* a, const void* b, void* out,
                              long long T, int K, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned grid = (unsigned)((T + 255) / 256);
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
#define RATE_CASE(OP) \
  case OP: rate_kernel<OP><<<grid, 256, 0, s>>>(pa, pb, po, T, K); break;
  switch (op) {
    RATE_CASE(MUL_LO)
    RATE_CASE(MAD_LO)
    RATE_CASE(MAD_HI)
    RATE_CASE(MAD_WIDE)
    RATE_CASE(ADD64)
    RATE_CASE(SHIFT_AND)
    RATE_CASE(MUL_F32)
    RATE_CASE(MAD_WIDE_SPLIT)
    RATE_CASE(MAD_CC)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RATE_CASE
  return (int)cudaGetLastError();
}

// CIOS: the field product of every kernel before the carry chain of
// field.cuh replaced it; a*b*2^(-32 NW) mod p (inputs canonical). Its
// (NW+2)-word accumulator takes any p < R.
template <int NW>
__device__ __forceinline__ Fp<NW> fp_mul_cios(const Fp<NW>& a,
                                              const Fp<NW>& b,
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


// Separated operand scanning: t = a * b (2 NW words), then NW rounds of
// t += m_i * p * 2^(32 i) with m_i = t[i] * n0inv; the carry out of round
// i's top word (position i + NW) enters round i + 1's.
template <int NW>
__device__ __forceinline__ Fp<NW> fp_mul_sos(const Fp<NW>& a, const Fp<NW>& b,
                                             const Mod<NW>& M) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[i + j] + C;
      t[i + j] = (uint32_t)s;
      C = s >> 32;
    }
    t[i + NW] = (uint32_t)C;
  }
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t m = t[i] * M.n0inv;
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)m * M.p[j] + t[i + j] + C;
      t[i + j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + NW] + C + top;
    t[i + NW] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  Fp<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[NW + k];
  return fp_reduce_once<NW>(r, top, M);
}

template <int NW, int VARIANT>
__global__ void __launch_bounds__(256)
cios_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, int64_t L, int K,
            const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> x = fp_load<NW>(a, L, i);
  Fp<NW> y = fp_load<NW>(b, L, i);
  for (int k = 0; k < K; ++k) {
    if constexpr (VARIANT == 0)
      x = fp_mul_cios<NW>(x, y, M);
    else if constexpr (VARIANT == 1)
      x = fp_mul_sos<NW>(x, y, M);
    else if constexpr (VARIANT == 2)
      x = fp_mul_chain<NW, false>(x, y, M);
    else
      x = fp_mul_chain<NW, true>(x, y, M);
  }
  fp_store<NW>(out, L, i, x);
}

// variant 4: element e on the GS lanes e GS .. e GS + GS - 1; lane j holds
// word j of x and p and every lane all words of b. Groups past L compute on
// element L - 1 and store nothing, so every lane of a warp takes part in
// the shuffles.
template <int NW>
__global__ void __launch_bounds__(256)
lanes_chain_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t L, int K,
                   const __grid_constant__ Mod<NW> M) {
  constexpr int GS = LaneGroup<NW>::GS;
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t e = t / GS;
  int j = (int)(t % GS);
  bool live = e < L;
  if (!live) e = L - 1;
  Fp<NW> y = fp_load<NW>(b, L, e);
  uint32_t x = 0, pj = 0;
  if (j < NW) {
    uint32_t lo = (uint32_t)a[(2 * j) * L + e];
    uint32_t hi = (uint32_t)a[(2 * j + 1) * L + e];
    x = (lo & 0xFFFFu) | (hi << 16);
  }
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k == j) pj = M.p[k];
  for (int k = 0; k < K; ++k) x = fp_mul_lanes<NW, GS>(x, y.w, pj, j, M);
  if (live && j < NW) {
    out[(2 * j) * L + e] = (int32_t)(x & 0xFFFFu);
    out[(2 * j + 1) * L + e] = (int32_t)(x >> 16);
  }
}

// variants 2-4: the bodies of the kernels' products (the latency probe's)
template <int NW>
static int chain_launch(int variant, const void* a, const void* b, void* out,
                        long long L, int K, const void* M, cudaStream_t s) {
  unsigned grid = (unsigned)((L + 255) / 256);
  const Mod<NW>* mod = (const Mod<NW>*)M;
  if (variant == 2)
    cios_kernel<NW, 2><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else if (variant == 3)
    cios_kernel<NW, 3><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else if (variant == 4) {
    // whole warps; one warp for a single element (the latency probe)
    long long lanes = (L * LaneGroup<NW>::GS + 31) / 32 * 32;
    int threads = lanes < 256 ? (int)lanes : 256;
    lanes_chain_kernel<NW><<<(unsigned)((lanes + threads - 1) / threads),
                             threads, 0, s>>>((const int32_t*)a,
                                              (const int32_t*)b, (int32_t*)out,
                                              L, K, *mod);
  }
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int NW>
static int cios_launch(int variant, const void* a, const void* b, void* out,
                       long long L, int K, const void* M, cudaStream_t s) {
  unsigned grid = (unsigned)((L + 255) / 256);
  const Mod<NW>* mod = (const Mod<NW>*)M;
  if (variant == 0)
    cios_kernel<NW, 0><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else if (variant == 1)
    cios_kernel<NW, 1><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else
    return chain_launch<NW>(variant, a, b, out, L, K, M, s);
  return (int)cudaGetLastError();
}

// variant 5: fp_mul_half, the kernels' product at an odd limb count (19
// limbs in NW = 10 words, R = 2^304: MNT4 and MNT6), NL limbs in and out
template <int NW, int NL>
__global__ void __launch_bounds__(256)
half_chain_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b, int32_t* __restrict__ out,
                  int64_t L, int K, const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> x = fp_load<NW, NL>(a, L, i);
  Fp<NW> y = fp_load<NW, NL>(b, L, i);
  for (int k = 0; k < K; ++k) x = fp_mul_half<NW>(x, y, M);
  fp_store<NW, NL>(out, L, i, x);
}

// nw: 32-bit words per element (6, 8, 12: every variant but 5; 24:
// variants 2-4, the product latency at 48 limbs; 10: variant 5 alone, 19
// limbs); M: the Mod<nw> of that width
extern "C" int lsn_probe_cios(int nw, int variant, const void* a,
                              const void* b, void* out, long long L, int K,
                              const void* M, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 6 && variant <= 4)
    return cios_launch<6>(variant, a, b, out, L, K, M, s);
  if (nw == 8 && variant <= 4)
    return cios_launch<8>(variant, a, b, out, L, K, M, s);
  if (nw == 12 && variant <= 4)
    return cios_launch<12>(variant, a, b, out, L, K, M, s);
  if (nw == 24 && variant >= 2 && variant <= 4)
    return chain_launch<24>(variant, a, b, out, L, K, M, s);
  if (nw == 10 && variant == 5) {
    half_chain_kernel<10, 19><<<(unsigned)((L + 255) / 256), 256, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, L, K,
        *(const Mod<10>*)M);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The latency of one dependent wide multiply-add: one thread runs K steps
// of x = lo(x) * y + x, each an IMAD.WIDE.U32 whose operands are the
// previous step's result, so the time over K is that instruction's
// latency (the yardstick of the products' latency bounds: their dependent
// chains in such instructions).
__global__ void dep_mad_kernel(uint32_t y, unsigned long long* out, int K) {
  uint64_t x = y | 1u;
#pragma unroll 8
  for (int k = 0; k < K; ++k) x = (uint64_t)(uint32_t)x * y + x;
  *out = x;
}

extern "C" int lsn_probe_dep_mad(unsigned y, void* out, int K,
                                 void* stream) {
  dep_mad_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      y, (unsigned long long*)out, K);
  return (int)cudaGetLastError();
}
