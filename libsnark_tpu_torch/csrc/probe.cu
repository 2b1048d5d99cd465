// Two measurement kernels for the card (no part of the proving path):
//
// rate_kernel: the card's counterpart of the TPU probe
// scripts/probe_vpu_ops.py:49. Every thread runs CHAINS independent
// dependent-chains of K steps of one 32-bit operation, so the pipes stay
// full and the time of a launch is steps / rate. The operations are the
// ones the field code is made of: mul.lo, mad.lo, mad.hi, the 32x32->64
// multiply-add CIOS is built from (mad.wide), a 64-bit add (add.cc + addc),
// shift+and, and an f32 multiply as the yardstick against the data sheet.
// The mad.wide step is w = lo(w) * y + w, written as the PTX instruction
// itself, with the register pair it replaces as its 64-bit addend. ptxas
// (CUDA 12.9, sm_90a) still does not make it one instruction: it emits
// IMAD.WIDE.U32 with a zero addend and adds the old pair with IADD3 and
// IADD3.X (probes.sass_loops prints the loop), and the Montgomery bodies
// below get adds beside their wide multiplies in the same way. So this row
// is the rate of a wide multiply-add as the toolchain builds it, not of
// the bare instruction.
// Bound: the instruction rate of the named operation; it moves 12 bytes per
// chain whatever K is.
//
// cios_kernel: the counterpart of scripts/probe_cios.py:98. K chained
// Montgomery products x <- x * b per lane in four bodies: CIOS (variant
// 0, the kernels' product until the carry chain replaced it), a separated
// operand-scanning product (variant 1: the full 2 NW-word product by rows
// of multiply-adds, then NW reduction rows with one running top carry) and
// the carry-chain product of field.cuh (PTX mad.lo.cc / madc.hi.cc chains
// over even and odd column accumulators) with its rounds unrolled (variant
// 2) and in a loop of two rounds (variant 3); fp_mul takes one of the two
// by the width. All return canonical values, so each is exact
// against the plain Montgomery product. Bound: 2 NW^2 + NW wide
// multiply-adds per product.
#include "field.cuh"

#define CHAINS 8

enum RateOp { MUL_LO = 0, MAD_LO, MAD_HI, MAD_WIDE, ADD64, SHIFT_AND, MUL_F32 };

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
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (OP == MUL_LO) x[c] = x[c] * y[c];
      if (OP == MAD_LO) x[c] = x[c] * y[c] + y[c];
      if (OP == MAD_HI) x[c] = __umulhi(x[c], y[c]) + y[c];
      if (OP == MAD_WIDE)
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
    if (OP == MAD_WIDE || OP == ADD64)
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
  else if (variant == 2)
    cios_kernel<NW, 2><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else if (variant == 3)
    cios_kernel<NW, 3><<<grid, 256, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, L, K, *mod);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// nw: 32-bit words per element (8 or 12); M: the Mod<nw> of that width
extern "C" int lsn_probe_cios(int nw, int variant, const void* a,
                              const void* b, void* out, long long L, int K,
                              const void* M, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return cios_launch<8>(variant, a, b, out, L, K, M, s);
  if (nw == 12) return cios_launch<12>(variant, a, b, out, L, K, M, s);
  return (int)cudaErrorInvalidValue;
}
