// Batched Montgomery multiplication: replaces the Pallas kernel
// libsnark_tpu/ops/pallas_fp.py:_build_mul (public mont_mul), for fields
// of NW = 8 (16 limbs) and NW = 12 (24 limbs) 32-bit words.
//
// One thread per lane: load a and b (2 NW limbs each, coalesced across the
// warp), run the NW x 32-bit carry-chain product of field.cuh, store 2 NW
// limbs.
// Bound on the card: 2 NW^2 + NW wide multiply-adds per product against
// 24 NW bytes moved per lane, so at 2^20 lanes it sits near the memory
// bound; the design keeps every intermediate in registers and touches each
// input and output word once.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t L,
                const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fp<NW> x = fp_load<NW>(a, L, i);
  Fp<NW> y = fp_load<NW>(b, L, i);
  fp_store<NW>(out, L, i, fp_mul<NW>(x, y, M));
}

template <int NW>
static void mont_mul_launch(const void* a, const void* b, void* out,
                            long long L, const void* M, void* stream) {
  int threads = 256;
  long long blocks = (L + threads - 1) / threads;
  mont_mul_kernel<NW><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, (int64_t)L,
      *(const Mod<NW>*)M);
}

// nw: 32-bit words per element; M: the Mod<nw> of that width
extern "C" int lsn_mont_mul(int nw, const void* a, const void* b, void* out,
                            long long L, const void* M, void* stream) {
  if (L > 0) {
    switch (nw) {
      case 8: mont_mul_launch<8>(a, b, out, L, M, stream); break;
      case 12: mont_mul_launch<12>(a, b, out, L, M, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
