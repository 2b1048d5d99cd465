// Elementwise group ops: replace the Pallas kernels
// libsnark_tpu/ops/pallas_ec.py:_build_dbl, _build_add, _build_madd and
// _build_aadd (public dbl / add / madd / aadd), for G1 (ext = 1) and G2
// over Fp2 (ext = 2), at NW = 8 and NW = 12 words, and for ext = 1 at
// NW = 24 (BW6-761's G1 and its G2 over Fp; ext = 2 there is refused).
//
// One thread per lane over the shared formulas of ec.cuh; the P == Q
// repair that the TPU wrapper runs as a second dbl launch under a
// lax.cond is a branch inside the thread. Bound on the card: the field
// products (6-16 per lane for G1, three times that for G2), i.e. integer
// multiply throughput; the kernels keep every coordinate in registers and
// read and write each lane's limbs once. add, the suffix scan's and the
// segment tree's kernel, is ordered for its register budget: the Z's
// first, P loaded again only for the rare P == Q repair (aadd too).
// madd_windows (below) runs a whole fixed-base exponentiation a lane, and
// aadd_rows the dense MSM's level 0 straight from the packed row table.
#include "ec.cuh"

template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::dbl)
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

// madd loads P and Q whole before the formula and repairs P == Q from
// the P it holds: on an H100 this ran faster than loading each coordinate
// at its use and loading P again for the repair, as add does (the
// kernel check's 2^16 lanes are 1-2 waves, where the loads' latency shows).
template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::madd)
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

// madd_windows: fixed-base exponentiation, the whole scan of the JAX
// package's batch_exp (libsnark_tpu/ops/msm.py:946-983, one Pallas madd a
// window) in one launch: lane i gets sum_w T[w, digit_w(s_i)] for
// w = 0 .. W-1, applied in that order with ec_madd's semantics, so the
// Jacobian limbs are those of the per-window loop. One thread per lane;
// the accumulator stays in registers across the W windows and is stored
// once. The thread takes its c-bit digits (1 <= c <= 16) from the
// scalar's plain 16-bit limbs ((nl, L) int32, limb k of lane i at k L + i)
// through a bit buffer that loads each limb once, when the next digit
// needs it: a digit that spans two limbs needs no second load, and past
// the last limb the digits are zero, as in JAX. The table is the packed
// row table (W 2^c rows of 2 E NW words, row w 2^c + j = j 2^(c w) base,
// all zero for infinity); each window reads one row, Q 16-byte pieces
// through the read-only cache: rows of 64-192 bytes, and the tables of the
// fixed-base paths (0.5-1.6 MB) stay in L2. Window 0 lifts the row (every
// lane starts at infinity); the windows after it run ec_madd, whose
// infinity branches a zero digit (row 0 of a window is infinity) takes.
// Bound: the field products, 11 a window (33 base products for G2); a lane
// moves 4 nl bytes in and 3 field elements out, W - 1 madds' worth.
template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::madd_win)
madd_windows_kernel(const uint4* __restrict__ rows,
                    const int32_t* __restrict__ scalars, int nl, int c, int W,
                    int32_t* ox, int32_t* oy, int32_t* oz, int64_t L,
                    const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const uint32_t mask = (1u << c) - 1;
  uint32_t buf = 0;                       // the scalar's bits not yet taken
  int avail = 0, next = 0;                // bits in buf; next limb to load
  // window w's row: (X2, Y2) and whether it is infinity (y == 0)
  auto load = [&](int w, Fe<NW, E>& X2, Fe<NW, E>& Y2) -> bool {
    if (avail < c) {                      // c <= 16: one limb suffices
      if (next < nl)
        buf |= ((uint32_t)__ldg(scalars + (int64_t)next * L + i) & 0xFFFFu)
               << avail;
      ++next;
      avail += 16;
    }
    uint32_t dig = buf & mask;
    buf >>= c;
    avail -= c;
    return row_fetch<NW, E>(rows, (int64_t)w << c | dig, X2, Y2);
  };
  Jac<NW, E> acc;                         // infinity, as ck.zero: (1, 1, 0)
  acc.X = fe_one<NW, E>(M);
  acc.Y = acc.X;
  acc.Z = fe_zero<NW, E>();
  if (W > 0) {                            // window 0 lifts its row
    Fe<NW, E> X2, Y2;
    if (!load(0, X2, Y2)) {
      acc.X = X2;
      acc.Y = Y2;
      acc.Z = fe_one<NW, E>(M);
    }
  }
#pragma unroll 1
  for (int w = 1; w < W; ++w) {
    Fe<NW, E> X2, Y2;
    bool q_inf = load(w, X2, Y2);
    acc = ec_madd<NW, E>(acc, X2, Y2, q_inf, true, M);
  }
  jac_store<NW, E>(ox, oy, oz, L, i, acc);
}

// aadd: both operands affine limb-major (FW, L) arrays with byte masks
// for infinity: 4 field loads and 3 stores per lane against 6 products. A
// lane with P == Q loads P again and doubles it (as add_kernel does).
template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::aadd)
aadd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
            const uint8_t* __restrict__ i1, const int32_t* __restrict__ x2,
            const int32_t* __restrict__ y2, const uint8_t* __restrict__ i2,
            int32_t* ox, int32_t* oy, int32_t* oz, int64_t L,
            const __grid_constant__ Mod<NW> M) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  bool inf1 = i1[i] != 0, inf2 = i2[i] != 0;
  Fe<NW, E> X1 = fe_load<NW, E>(x1, L, i);
  Fe<NW, E> Y1 = fe_load<NW, E>(y1, L, i);
  Fe<NW, E> X2 = fe_load<NW, E>(x2, L, i);
  Fe<NW, E> Y2 = fe_load<NW, E>(y2, L, i);
  Jac<NW, E> R;
  if (inf1 || inf2)
    R = ec_aadd_inf<NW, E>(X1, Y1, inf1, X2, Y2, inf2, M);
  else if (!ec_aadd_finite<NW, E>(X1, Y1, X2, Y2, R, M))
    R = ec_aadd_repair<NW, E>(fe_load_again<NW, E>(x1, L, i),
                              fe_load_again<NW, E>(y1, L, i), M);
  jac_store<NW, E>(ox, oy, oz, L, i, R);
}

// aadd_rows: level 0 of one chunk of the dense MSM's bucket tree
// (ops/msm.py _dense_reduce; the JAX package's window_sums_dense,
// libsnark_tpu/ops/msm.py:476-493, gathers the rows with jnp.take,
// transposes them and calls the Pallas aadd) in one launch, straight from
// the packed row table. Lane t = (r Wn + w) nb + b takes depths base + r
// and base + r + half of bucket (w_lo + w, b), so the output is the (half,
// Wn nb) batch of the gathered form's aadd(lo, hi). A depth's row is
// gidx[(w_lo + w) m + clamp(start + depth, 0, m - 1)] of the signed row
// table (2m rows: [x | y], then [x | -y]); it is infinity where its y words
// are zero or depth >= count, and its words are read either way (a lane
// whose operands are both infinity returns (x2, y2, 0) as the gathered form
// does). Bound: the 6 products (18 base products for G2) against 2 rows,
// 2 index words in and 3 field elements out a lane; the torch passes of
// the gathered form (the row gather, the limb split, the infinity
// reduction, the operands' contiguous copies) moved some 3x the kernel's
// own bytes. One lane a thread: a form that walked the lanes over a
// resident grid and staged the next lane's rows in shared memory with
// cp.async ran slower at every width on an H100 (PERF.md). A lane
// with P == Q reads its first row again for the repair.
template <int NW, int E>
__global__ void __launch_bounds__(128, Blocks<NW, E>::aadd)
aadd_rows_kernel(const uint4* __restrict__ rows,
                 const int32_t* __restrict__ gidx,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts, int ncols, int m,
                 int base, int half, int w_lo, int Wn, int nb, int32_t* ox,
                 int32_t* oy, int32_t* oz, int64_t L,
                 const __grid_constant__ Mod<NW> M) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;      // L < 2^31: checked
  if (t >= L) return;
  int span = Wn * nb;
  int r = t / span;
  int wb = t - r * span;
  int w = wb / nb;
  int64_t cell = (int64_t)(w_lo + w) * ncols + (wb - w * nb);
  int st = __ldg(starts + cell), ct = __ldg(counts + cell);
  const int32_t* g = gidx + (int64_t)(w_lo + w) * m;
  int d1 = base + r, d2 = d1 + half;
  auto row_of = [&](int d) -> int64_t {
    int64_t pos = (int64_t)st + d;
    return __ldg(g + (pos < 0 ? 0 : pos >= m ? m - 1 : pos));
  };
  int64_t g1 = row_of(d1), g2 = row_of(d2);
  Fe<NW, E> X1, Y1, X2, Y2;
  bool inf1 = row_fetch<NW, E>(rows, g1, X1, Y1) || d1 >= ct;
  bool inf2 = row_fetch<NW, E>(rows, g2, X2, Y2) || d2 >= ct;
  Jac<NW, E> R;
  if (inf1 || inf2) {
    R = ec_aadd_inf<NW, E>(X1, Y1, inf1, X2, Y2, inf2, M);
  } else if (!ec_aadd_finite<NW, E>(X1, Y1, X2, Y2, R, M)) {
    row_fetch_again<NW, E>(rows, g1, X1, Y1);
    R = ec_aadd_repair<NW, E>(X1, Y1, M);
  }
  jac_store<NW, E>(ox, oy, oz, L, t, R);
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
// a width built for ext = 1 only (lsn_built refuses ext = 2 there)
#define LAUNCH_W1(NWV, KERNEL, ...)                                          \
  case NWV:                                                                  \
    KERNEL<NWV, 1><<<grid_for(L, 128), 128, 0, s>>>(__VA_ARGS__,             \
                                                    *(const Mod<NWV>*)M);    \
    break;
#define LAUNCH(KERNEL, ...)                                                  \
  if (!lsn_built(nw, ext)) return (int)cudaErrorInvalidValue;                \
  if (L > 0) {                                                               \
    cudaStream_t s = (cudaStream_t)stream;                                   \
    switch (nw) {                                                            \
      LAUNCH_W(8, KERNEL, __VA_ARGS__)                                       \
      LAUNCH_W(12, KERNEL, __VA_ARGS__)                                      \
      LAUNCH_W1(24, KERNEL, __VA_ARGS__)                                     \
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

// rows: the (W 2^c, 2 ext nw) packed row table, 16-byte aligned; scalars:
// (nl, L) plain 16-bit limbs
extern "C" int lsn_ec_madd_windows(int nw, int ext, const void* rows,
                                   const void* scalars, int nl, int c, int W,
                                   void* ox, void* oy, void* oz, long long L,
                                   const void* M, void* stream) {
  if (c < 1 || c > 16 || W < 0 || W > (1 << 30) >> c || nl < 1 ||
      (uintptr_t)rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  LAUNCH(madd_windows_kernel, (const uint4*)rows, I32(scalars), nl, c, W,
         O32(ox), O32(oy), O32(oz), L)
}

extern "C" int lsn_ec_aadd(int nw, int ext, const void* x1, const void* y1,
                           const void* i1, const void* x2, const void* y2,
                           const void* i2, void* ox, void* oy, void* oz,
                           long long L, const void* M, void* stream) {
  LAUNCH(aadd_kernel, I32(x1), I32(y1), U8(i1), I32(x2), I32(y2), U8(i2),
         O32(ox), O32(oy), O32(oz), L)
}

// rows: the signed (2m, 2 ext nw) packed row table, 16-byte aligned; gidx:
// (W m) int32 signed row indices; starts / counts: (W, ncols) int32 bucket
// runs; the chunk: depths base .. base + 2 half - 1 of windows w_lo ..
// w_lo + Wn - 1, buckets 0 .. nb - 1; L = half Wn nb output lanes
extern "C" int lsn_ec_aadd_rows(int nw, int ext, const void* rows,
                                const void* gidx, const void* starts,
                                const void* counts, int ncols, int m,
                                int base, int half, int w_lo, int Wn, int nb,
                                void* ox, void* oy, void* oz, long long L,
                                const void* M, void* stream) {
  if (m < 1 || half < 1 || Wn < 1 || nb < 1 || nb > ncols || w_lo < 0 ||
      base < 0 || L != (long long)half * Wn * nb || L >= (1LL << 31) ||
      (long long)base + 2LL * half >= (1LL << 31) ||
      (uintptr_t)rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  LAUNCH(aadd_rows_kernel, (const uint4*)rows, I32(gidx), I32(starts),
         I32(counts), ncols, m, base, half, w_lo, Wn, nb, O32(ox), O32(oy),
         O32(oz), L)
}