// Pippenger bucket reduce and Horner window combine: replace the Pallas
// kernels libsnark_tpu/ops/pallas_bucket.py:_build_bucket_reduce (public
// bucket_reduce) and _build_horner (public horner_combine).
//
// bucket_reduce: one thread per bucket. Buckets own contiguous runs of the
// per-window sorted signed index list (idx + sign * m); the thread walks
// its run, gathers each point's row [x limbs | y limbs] from the (m, 2FW)
// row table itself (no per-window row copy), negates y for a negative
// digit, and runs the masked madd chain with the P == Q repair in-thread.
// Rows with y == 0 are points at infinity and are skipped. Nothing is
// carried across blocks, so the sums are deterministic. The TPU kernel's
// 128-bucket tiles, R_SUB roll tree, VMEM caps and two-class depth are
// artifacts of Mosaic and are not carried over.
// Bound on the card: the madd field products (about 11 per point for G1,
// 33 for G2), integer multiply throughput; the gathers move one row per
// point. Load balance follows the bucket occupancy.
//
// horner_combine: a single thread computes sum_w 2^(c w) S_w MSB first,
// c doublings and one add per window: a few hundred group ops of latency.
//
// Instantiated for NW = 8 and NW = 12 words; a G1 row is 16 NW bytes, a G2
// row twice that.
#include "ec.cuh"

template <int NW, int E>
__global__ void __launch_bounds__(128)
bucket_reduce_kernel(const int32_t* __restrict__ rows, int64_t m,
                     const int32_t* __restrict__ gidx,
                     const int64_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int64_t nb,
                     int32_t* ox, int32_t* oy, int32_t* oz,
                     const __grid_constant__ Mod<NW> M) {
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int FW = E * 2 * NW;
  Jac<NW, E> acc;
  acc.X = fe_one<NW, E>(M);
  acc.Y = fe_one<NW, E>(M);
  acc.Z = fe_zero<NW, E>();
  int64_t s0 = starts[b];
  int cnt = counts[b];
  for (int k = 0; k < cnt; ++k) {
    int64_t g = gidx[s0 + k];
    bool neg = g >= m;
    int64_t i = neg ? g - m : g;
    const int32_t* row = rows + i * (2 * FW);
    Fe<NW, E> X2 = fe_load_row<NW, E>(row);
    Fe<NW, E> Y2 = fe_load_row<NW, E>(row + FW);
    bool q_inf = fe_is_zero<NW, E>(Y2);
    if (neg) Y2 = fe_neg<NW, E>(Y2, M);
    acc = ec_madd<NW, E>(acc, X2, Y2, q_inf, true, M);
  }
  jac_store<NW, E>(ox, oy, oz, nb, b, acc);
}

template <int NW, int E>
__global__ void horner_kernel(const int32_t* __restrict__ sx,
                              const int32_t* __restrict__ sy,
                              const int32_t* __restrict__ sz, int64_t W,
                              int c, int32_t* ox, int32_t* oy, int32_t* oz,
                              const __grid_constant__ Mod<NW> M) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac<NW, E> acc = jac_load<NW, E>(sx, sy, sz, W, W - 1);
  for (int64_t w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = ec_dbl<NW, E>(acc, M);
    acc = ec_add<NW, E>(acc, jac_load<NW, E>(sx, sy, sz, W, w), M);
  }
  jac_store<NW, E>(ox, oy, oz, 1, 0, acc);
}

#define I32(p) ((const int32_t*)(p))
#define O32(p) ((int32_t*)(p))
// launch KERNEL<nw, ext> on GRID x THREADS; M: the Mod<nw> of that width
#define LAUNCH_W(NWV, KERNEL, GRID, THREADS, ...)                            \
  case NWV:                                                                  \
    if (ext == 1)                                                            \
      KERNEL<NWV, 1><<<GRID, THREADS, 0, s>>>(__VA_ARGS__,                   \
                                              *(const Mod<NWV>*)M);          \
    else                                                                     \
      KERNEL<NWV, 2><<<GRID, THREADS, 0, s>>>(__VA_ARGS__,                   \
                                              *(const Mod<NWV>*)M);          \
    break;
#define LAUNCH(KERNEL, GRID, THREADS, ...)                                   \
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;               \
  switch (nw) {                                                              \
    LAUNCH_W(8, KERNEL, GRID, THREADS, __VA_ARGS__)                          \
    LAUNCH_W(12, KERNEL, GRID, THREADS, __VA_ARGS__)                         \
    default: return (int)cudaErrorInvalidValue;                              \
  }

extern "C" int lsn_bucket_reduce(int nw, int ext, const void* rows,
                                 long long m, const void* gidx,
                                 const void* starts, const void* counts,
                                 long long nb, void* ox, void* oy, void* oz,
                                 const void* M, void* stream) {
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned grid = (unsigned)((nb + 127) / 128);
    LAUNCH(bucket_reduce_kernel, grid, 128, I32(rows), m, I32(gidx),
           (const int64_t*)starts, I32(counts), nb, O32(ox), O32(oy), O32(oz))
  }
  return (int)cudaGetLastError();
}

extern "C" int lsn_horner(int nw, int ext, const void* sx, const void* sy,
                          const void* sz, long long W, int c, void* ox,
                          void* oy, void* oz, const void* M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH(horner_kernel, 1, 32, I32(sx), I32(sy), I32(sz), W, c, O32(ox),
         O32(oy), O32(oz))
  return (int)cudaGetLastError();
}
