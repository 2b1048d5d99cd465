// Elementwise group ops: replace the Pallas kernels
// libsnark_tpu/ops/pallas_ec.py:_build_dbl, _build_add, _build_madd and
// _build_aadd (public dbl / add / madd / aadd), for G1 (ext = 1) and G2
// over Fp2 (ext = 2), at NW = 8 and NW = 12 words.
//
// One thread per lane over the shared formulas of ec.cuh; the P == Q
// repair that the TPU wrapper runs as a second dbl launch under a
// lax.cond is a branch inside the thread. Bound on the card: the field
// products (6-16 per lane for G1, three times that for G2), i.e. integer
// multiply throughput; the kernels keep every coordinate in registers and
// read and write each lane's limbs once. add, the suffix scan's and the
// segment tree's kernel, is ordered for its register budget: the Z's
// first, P loaded again only for the rare P == Q repair.
#include "ec.cuh"

template <int NW, int E>
__global__ void __launch_bounds__(128)
dbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
           const int32_t* __restrict__ z, int32_t* ox, int32_t* oy,
           int32_t* oz, int64_t L, int reps,
           const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Jac<NW, E> P = jac_load<NW, E>(x, y, z, L, i);
  for (int r = 0; r < reps; ++r) P = ec_dbl<NW, E>(P, M);
  jac_store<NW, E>(ox, oy, oz, L, i, P);
}

// P's coordinates again, through volatile loads, for the rare P == Q
// repair: the compiler cannot reuse the values loaded for the formula, so
// those die at their use and not at the repair.
template <int NW, int E>
__device__ __forceinline__ Fe<NW, E> fe_load_again(const volatile int32_t* base,
                                                   int64_t L, int64_t i) {
  Fe<NW, E> r;
#pragma unroll
  for (int c = 0; c < E; ++c)
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t lo = (uint32_t)base[(int64_t)(2 * (c * NW + k)) * L + i];
      uint32_t hi = (uint32_t)base[(int64_t)(2 * (c * NW + k) + 1) * L + i];
      r.c[c].w[k] = (lo & 0xFFFFu) | (hi << 16);
    }
  return r;
}

// add: the Z's first (infinity on either side copies the other point),
// then X1, Y1, X2, Y2 before the formula (loading each at its use instead
// ran no faster on an H100, and for G1 at 24 limbs needed 212 registers
// or spilled); a lane with P == Q loads P again and doubles it.
template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::add)
add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
           int32_t* ox, int32_t* oy, int32_t* oz, int64_t L,
           const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fe<NW, E> Z1 = fe_load<NW, E>(z1, L, i);
  Fe<NW, E> Z2 = fe_load<NW, E>(z2, L, i);
  Jac<NW, E> R;
  if (fe_is_zero<NW, E>(Z1)) {
    R.X = fe_load<NW, E>(x2, L, i);
    R.Y = fe_load<NW, E>(y2, L, i);
    R.Z = Z2;
  } else if (fe_is_zero<NW, E>(Z2)) {
    R.X = fe_load<NW, E>(x1, L, i);
    R.Y = fe_load<NW, E>(y1, L, i);
    R.Z = Z1;
  } else if (!ec_add_finite<NW, E>(
                 fe_load<NW, E>(x1, L, i), fe_load<NW, E>(y1, L, i), Z1,
                 fe_load<NW, E>(x2, L, i), fe_load<NW, E>(y2, L, i), Z2, R,
                 M)) {
    Jac<NW, E> P;
    P.X = fe_load_again<NW, E>(x1, L, i);
    P.Y = fe_load_again<NW, E>(y1, L, i);
    P.Z = fe_load_again<NW, E>(z1, L, i);
    R = ec_dbl<NW, E>(P, M);
  }
  jac_store<NW, E>(ox, oy, oz, L, i, R);
}

template <int NW, int E>
__global__ void __launch_bounds__(128)
madd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
            const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
            const int32_t* __restrict__ y2, const uint8_t* __restrict__ q_inf,
            const uint8_t* __restrict__ valid, int32_t* ox, int32_t* oy,
            int32_t* oz, int64_t L, const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Jac<NW, E> P = jac_load<NW, E>(x1, y1, z1, L, i);
  Fe<NW, E> X2 = fe_load<NW, E>(x2, L, i);
  Fe<NW, E> Y2 = fe_load<NW, E>(y2, L, i);
  bool qi = q_inf[i] != 0;
  bool va = valid == nullptr || valid[i] != 0;
  jac_store<NW, E>(ox, oy, oz, L, i, ec_madd<NW, E>(P, X2, Y2, qi, va, M));
}

// aadd: both operands affine limb-major (FW, L) arrays with byte masks
// for infinity: 4 field loads and 3 stores per lane against 6 products.
template <int NW, int E>
__global__ void __launch_bounds__(128)
aadd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
            const uint8_t* __restrict__ i1, const int32_t* __restrict__ x2,
            const int32_t* __restrict__ y2, const uint8_t* __restrict__ i2,
            int32_t* ox, int32_t* oy, int32_t* oz, int64_t L,
            const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  Fe<NW, E> X1 = fe_load<NW, E>(x1, L, i);
  Fe<NW, E> Y1 = fe_load<NW, E>(y1, L, i);
  Fe<NW, E> X2 = fe_load<NW, E>(x2, L, i);
  Fe<NW, E> Y2 = fe_load<NW, E>(y2, L, i);
  jac_store<NW, E>(ox, oy, oz, L, i,
                   ec_aadd<NW, E>(X1, Y1, i1[i] != 0, X2, Y2, i2[i] != 0, M));
}

static inline unsigned grid_for(long long L, int threads) {
  return (unsigned)((L + threads - 1) / threads);
}

#define I32(p) ((const int32_t*)(p))
#define O32(p) ((int32_t*)(p))
#define U8(p) ((const uint8_t*)(p))
// launch KERNEL<nw, ext> over L lanes, 128 threads a block; M: the Mod<nw>
#define LAUNCH_W(NWV, KERNEL, ...)                                           \
  case NWV:                                                                  \
    if (ext == 1)                                                            \
      KERNEL<NWV, 1><<<grid_for(L, 128), 128, 0, s>>>(                       \
          __VA_ARGS__, *(const Mod<NWV>*)M);                                 \
    else                                                                     \
      KERNEL<NWV, 2><<<grid_for(L, 128), 128, 0, s>>>(                       \
          __VA_ARGS__, *(const Mod<NWV>*)M);                                 \
    break;
#define LAUNCH(KERNEL, ...)                                                  \
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;               \
  if (L > 0) {                                                               \
    cudaStream_t s = (cudaStream_t)stream;                                   \
    switch (nw) {                                                            \
      LAUNCH_W(8, KERNEL, __VA_ARGS__)                                       \
      LAUNCH_W(12, KERNEL, __VA_ARGS__)                                      \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
  }                                                                          \
  return (int)cudaGetLastError();

extern "C" int lsn_ec_dbl(int nw, int ext, const void* x, const void* y,
                          const void* z, void* ox, void* oy, void* oz,
                          long long L, int reps, const void* M,
                          void* stream) {
  LAUNCH(dbl_kernel, I32(x), I32(y), I32(z), O32(ox), O32(oy), O32(oz), L,
         reps)
}

extern "C" int lsn_ec_add(int nw, int ext, const void* x1, const void* y1,
                          const void* z1, const void* x2, const void* y2,
                          const void* z2, void* ox, void* oy, void* oz,
                          long long L, const void* M, void* stream) {
  LAUNCH(add_kernel, I32(x1), I32(y1), I32(z1), I32(x2), I32(y2), I32(z2),
         O32(ox), O32(oy), O32(oz), L)
}

extern "C" int lsn_ec_madd(int nw, int ext, const void* x1, const void* y1,
                           const void* z1, const void* x2, const void* y2,
                           const void* q_inf, const void* valid, void* ox,
                           void* oy, void* oz, long long L, const void* M,
                           void* stream) {
  LAUNCH(madd_kernel, I32(x1), I32(y1), I32(z1), I32(x2), I32(y2), U8(q_inf),
         U8(valid), O32(ox), O32(oy), O32(oz), L)
}

extern "C" int lsn_ec_aadd(int nw, int ext, const void* x1, const void* y1,
                           const void* i1, const void* x2, const void* y2,
                           const void* i2, void* ox, void* oy, void* oz,
                           long long L, const void* M, void* stream) {
  LAUNCH(aadd_kernel, I32(x1), I32(y1), U8(i1), I32(x2), I32(y2), U8(i2),
         O32(ox), O32(oy), O32(oz), L)
}
