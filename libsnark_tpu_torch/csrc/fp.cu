// Batched Montgomery multiplication: replaces the Pallas kernel
// libsnark_tpu/ops/pallas_fp.py:_build_mul (public mont_mul), for fields
// of NL = 12, 16, 19, 24 and 48 16-bit limbs (NW = 6, 8, 10, 12 and 24
// 32-bit words). Beside it the field addition and subtraction
// (fp_addsub_kernel: the JAX package's FpKernel.add / sub, jnp code that
// XLA fuses on the TPU), one launch where torch's int64 limb passes take
// some twenty kernels and a host read of their carries.
//
// One thread per lane: load a and b (NL limbs each, coalesced across the
// warp), run the NW x 32-bit product of field.cuh (the carry chain at an
// even NL; at NL = 19, where R = 2^304 is no power of 2^32, fp_mul_half:
// nine word rounds and a half-word round), store NL limbs.
// Bound on the card: 2 NW^2 + NW wide multiply-adds per product against
// 12 NL bytes moved per lane, so at 2^20 lanes it sits near the memory
// bound; the design keeps every intermediate in registers and touches each
// input and output word once.
#include "field.cuh"

template <int NW, int NL>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t L,
                const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> x = fp_load<NW, NL>(a, L, i);
  Fp<NW> y = fp_load<NW, NL>(b, L, i);
  if constexpr (NL == 2 * NW)
    fp_store<NW, NL>(out, L, i, fp_mul<NW>(x, y, M));
  else
    fp_store<NW, NL>(out, L, i, fp_mul_half<NW>(x, y, M));
}

template <int NW, int NL>
static void mont_mul_launch(const void* a, const void* b, void* out,
                            long long L, const void* M, void* stream) {
  int threads = 256;
  long long blocks = (L + threads - 1) / threads;
  mont_mul_kernel<NW, NL>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)a, (const int32_t*)b, (int32_t*)out, (int64_t)L,
          *(const Mod<NW>*)M);
}

// a + b (SUB = 0) or a - b (SUB = 1) mod p, one thread per lane: for any
// 16-bit limbs, the value torch's limb passes give (one conditional
// subtraction of p after an add, one addition of p after a borrow; the low
// NL limbs). Bound: 12 NL bytes a lane, no products.
template <int NW, int NL, int SUB>
__global__ void __launch_bounds__(256)
fp_addsub_kernel(const int32_t* __restrict__ a,
                 const int32_t* __restrict__ b, int32_t* __restrict__ out,
                 int64_t L, const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> x = fp_load<NW, NL>(a, L, i);
  Fp<NW> y = fp_load<NW, NL>(b, L, i);
  fp_store<NW, NL>(out, L, i, SUB ? fp_sub<NW>(x, y, M) : fp_add<NW>(x, y, M));
}

template <int NW, int NL>
static void addsub_launch(int sub, const void* a, const void* b, void* out,
                          long long L, const void* M, void* stream) {
  int threads = 256;
  unsigned blocks = (unsigned)((L + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const Mod<NW>& m = *(const Mod<NW>*)M;
  if (sub)
    fp_addsub_kernel<NW, NL, 1><<<blocks, threads, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, (int64_t)L, m);
  else
    fp_addsub_kernel<NW, NL, 0><<<blocks, threads, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, (int64_t)L, m);
}

// The Montgomery product with a wide first operand (the JAX package's
// FpKernel.mul_wide, a jnp scan there): a has WA >= NL 16-bit limbs (value
// below 2^(16 WA)), b is canonical, out = a b 2^(-16 WA) mod p, canonical.
// One thread per lane. b sits in registers as NW words; a is read a word
// (two limbs) a round, straight from its coalesced rows, so WA is a runtime
// argument and the outer loop is not unrolled: ceil(WA / 2) CIOS rounds of
// 64-bit products (fp_mul_half's round), the last a half-word round when WA
// is odd. After round i the running value is below (a_low b + m p) / 2^(32
// i) < 2p, so NW + 2 words hold it and one conditional subtraction ends it.
// b broadcasts from the right: lane t reads b's lane t % Lb (a twiddle table
// of Lb lanes under a batch of L / Lb of them, or one constant, Lb = 1).
// Bound: (WA + 2 NL) 4 bytes a lane against (WA / 2) 2 NW wide
// multiply-adds, so at the NTT's shapes it sits near the memory bound.
template <int NW, int NL>
__global__ void __launch_bounds__(256)
mul_wide_kernel(const int32_t* __restrict__ a, int wa,
                const int32_t* __restrict__ b, int64_t Lb,
                int32_t* __restrict__ out, int64_t L,
                const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> y = fp_load<NW, NL>(b, Lb, Lb == 1 ? 0 : i % Lb);
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
#pragma unroll 1
  for (int w = 0; 2 * w + 1 < wa; ++w) {
    uint32_t ai = ((uint32_t)a[(2 * w) * L + i] & 0xFFFFu)
        | ((uint32_t)a[(2 * w + 1) * L + i] << 16);
    cios_mad<NW>(t, y.w, ai);
    uint32_t m = t[0] * M.n0inv;
    uint64_t c = ((uint64_t)m * M.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      uint64_t s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
    t[NW + 1] = 0;
  }
  Fp<NW> r;
  if (wa & 1) {
    // half round on a's top limb: t = (t + a_top b + m p) / 2^16 with m =
    // t_0 (-p^-1) mod 2^16
    cios_mad<NW>(t, y.w, (uint32_t)a[(wa - 1) * L + i] & 0xFFFFu);
    uint32_t m = (t[0] * M.n0inv) & 0xFFFFu;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    // the value is below 2p < 2^(32 NW) after the shift
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = (t[j] >> 16) | (t[j + 1] << 16);
    fp_store<NW, NL>(out, L, i, fp_reduce_once<NW>(r, 0, M));
    return;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  fp_store<NW, NL>(out, L, i, fp_reduce_once<NW>(r, t[NW], M));
}

template <int NW, int NL>
static void mul_wide_launch(const void* a, int wa, const void* b,
                            long long Lb, void* out, long long L,
                            const void* M, void* stream) {
  int threads = 256;
  unsigned blocks = (unsigned)((L + threads - 1) / threads);
  mul_wide_kernel<NW, NL><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, wa, (const int32_t*)b, (int64_t)Lb, (int32_t*)out,
      (int64_t)L, *(const Mod<NW>*)M);
}

// nl: 16-bit limbs of b and out (the field's); wa: limbs of a (>= nl); Lb:
// b's lanes (L a multiple of it); M: the Mod<(nl + 1) / 2> of that width.
// Built at the widths the MXU NTT meets: the 16-limb scalar fields
// (alt_bn128, BLS12-377) and the 24-limb one (BW6-761), and at 12 and 19
// limbs (edwards, MNT4, MNT6)
extern "C" int lsn_mul_wide(int nl, const void* a, int wa, const void* b,
                            long long Lb, void* out, long long L,
                            const void* M, void* stream) {
  if (wa < nl || Lb < 1) return (int)cudaErrorInvalidValue;
  if (L > 0) {
    switch (nl) {
      case 12: mul_wide_launch<6, 12>(a, wa, b, Lb, out, L, M, stream); break;
      case 16: mul_wide_launch<8, 16>(a, wa, b, Lb, out, L, M, stream); break;
      case 19: mul_wide_launch<10, 19>(a, wa, b, Lb, out, L, M, stream); break;
      case 24: mul_wide_launch<12, 24>(a, wa, b, Lb, out, L, M, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// nl: 16-bit limbs per element; sub: 0 add, 1 subtract; M: the
// Mod<(nl + 1) / 2> of that width
extern "C" int lsn_fp_addsub(int nl, int sub, const void* a, const void* b,
                             void* out, long long L, const void* M,
                             void* stream) {
  if (L > 0) {
    switch (nl) {
      case 12: addsub_launch<6, 12>(sub, a, b, out, L, M, stream); break;
      case 16: addsub_launch<8, 16>(sub, a, b, out, L, M, stream); break;
      case 19: addsub_launch<10, 19>(sub, a, b, out, L, M, stream); break;
      case 24: addsub_launch<12, 24>(sub, a, b, out, L, M, stream); break;
      case 48: addsub_launch<24, 48>(sub, a, b, out, L, M, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// nl: 16-bit limbs per element; M: the Mod<(nl + 1) / 2> of that width
extern "C" int lsn_mont_mul(int nl, const void* a, const void* b, void* out,
                            long long L, const void* M, void* stream) {
  if (L > 0) {
    switch (nl) {
      case 12: mont_mul_launch<6, 12>(a, b, out, L, M, stream); break;
      case 16: mont_mul_launch<8, 16>(a, b, out, L, M, stream); break;
      case 19: mont_mul_launch<10, 19>(a, b, out, L, M, stream); break;
      case 24: mont_mul_launch<12, 24>(a, b, out, L, M, stream); break;
      case 48: mont_mul_launch<24, 48>(a, b, out, L, M, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
