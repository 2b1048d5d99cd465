// Pippenger bucket reduce and Horner window combine: replace the Pallas
// kernels libsnark_tpu/ops/pallas_bucket.py:_build_bucket_reduce (public
// bucket_reduce) and _build_horner (public horner_combine).
//
// bucket_reduce: one thread per segment (a bucket's run of the per-window
// sorted signed index list idx + sign * m, cut to a bounded length). The
// thread walks its segment, gathers each point's row from the packed
// (m, 2 E NW) row table of ops/msm.py row_table -- x then y, each E NW
// 32-bit words, the register layout, so a G1 row at NW = 12 is 96 bytes --
// negates y for a negative digit, and runs the madd chain with the P == Q
// repair in-thread. Rows with y == 0 are points at infinity and are
// skipped. Nothing is carried across blocks, so the sums are
// deterministic. The TPU kernel's 128-bucket tiles, R_SUB roll tree, VMEM
// caps and two-class depth are artifacts of Mosaic and are not carried
// over.
// Bound on the card: the madd field products (11 per row for G1, 33 base
// products for G2), integer multiply throughput. What the design does
// about the rest:
// * Segments go to threads in the order the caller gives (longest first),
//   so the 32 threads of a warp walk runs of about the same length and a
//   warp does not wait on its longest; each thread writes its segment's
//   own output slot, so the sums do not depend on the order.
// * The next row is copied global -> shared with cp.async (16-byte pieces,
//   the thread's own slot, laid out piece-major so that a warp's reads hit
//   32 banks) while the current madd runs; the gather's latency is off the
//   chain and the row costs no registers until it is read. On an H100 this
//   ran 4-5 % faster for G1 at 24 limbs than loading each row when its
//   madd starts, and within 2 % of it elsewhere.
// * The madd of ec.cuh keeps at most six field elements live, and the
//   kernel's register budget is set per width (Blocks<NW, E>::bucket).
//
// horner_combine: a single thread computes sum_w 2^(c w) S_w MSB first,
// c doublings and one add per window: a few hundred group ops of latency.
//
// Instantiated for NW = 8 and NW = 12 words.
#include "ec.cuh"

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the E NW words of x and of y from a row's 2 E NW words
template <int NW, int E>
__device__ __forceinline__ void row_point(const uint32_t* w, Fe<NW, E>& X,
                                          Fe<NW, E>& Y) {
#pragma unroll
  for (int c = 0; c < E; ++c)
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      X.c[c].w[k] = w[c * NW + k];
      Y.c[c].w[k] = w[(E + c) * NW + k];
    }
}

template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::bucket)
bucket_reduce_kernel(const uint4* __restrict__ rows, int64_t m,
                     const int32_t* __restrict__ gidx,
                     const int64_t* __restrict__ starts,
                     const int32_t* __restrict__ counts,
                     const int64_t* __restrict__ order, int64_t nb,
                     int32_t* ox, int32_t* oy, int32_t* oz,
                     const __grid_constant__ Mod<NW> M) {
  constexpr int Q = E * NW / 2;           // 16-byte pieces of a row
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  int64_t b = order ? order[t] : t;
  Jac<NW, E> acc;
  acc.X = fe_one<NW, E>(M);
  acc.Y = fe_one<NW, E>(M);
  acc.Z = fe_zero<NW, E>();
  const int32_t* g = gidx + starts[b];
  int cnt = counts[b];
  __shared__ uint4 stage[Q][128];
  uint32_t slot = (uint32_t)__cvta_generic_to_shared(&stage[0][threadIdx.x]);
  auto fetch = [&](int64_t gi) {
    const uint4* row = rows + (gi >= m ? gi - m : gi) * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) cp_async16(slot + q * 128 * 16, row + q);
  };
  int64_t gi = cnt > 0 ? g[0] : 0;        // row of this step
  int64_t gn = cnt > 1 ? g[1] : 0;        // row of the next step
  if (cnt > 0) fetch(gi);
  for (int k = 0; k < cnt; ++k) {
    int64_t gk = gi;
    uint32_t w[4 * Q];
    cp_async_wait_all();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint4 v = stage[q][threadIdx.x];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    if (k + 1 < cnt) {                    // read above: the slot is free
      fetch(gn);
      gi = gn;
      gn = k + 2 < cnt ? g[k + 2] : 0;
    }
    Fe<NW, E> X2, Y2;
    row_point<NW, E>(w, X2, Y2);
    bool q_inf = fe_is_zero<NW, E>(Y2);
    if (gk >= m) Y2 = fe_neg<NW, E>(Y2, M);
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
#define I64(p) ((const int64_t*)(p))
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

// rows: the packed (m, 2 ext nw) int32 row table; order: nb segment ids
// (thread t takes segment order[t]) or null for 0 .. nb - 1
extern "C" int lsn_bucket_reduce(int nw, int ext, const void* rows,
                                 long long m, const void* gidx,
                                 const void* starts, const void* counts,
                                 const void* order, long long nb, void* ox,
                                 void* oy, void* oz, const void* M,
                                 void* stream) {
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned grid = (unsigned)((nb + 127) / 128);
    LAUNCH(bucket_reduce_kernel, grid, 128, (const uint4*)rows, m, I32(gidx),
           I64(starts), I32(counts), I64(order), nb, O32(ox), O32(oy),
           O32(oz))
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
