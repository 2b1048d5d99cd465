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
// first, P loaded again only for the rare P == Q repair. madd_windows
// (below) runs a whole fixed-base exponentiation a lane.
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
  constexpr int Q = E * NW / 2;           // 16-byte pieces of a row
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
    const uint4* row = rows + ((int64_t)w << c | dig) * Q;
    uint32_t v[4 * Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint4 p = __ldg(row + q);
      v[4 * q] = p.x; v[4 * q + 1] = p.y; v[4 * q + 2] = p.z; v[4 * q + 3] = p.w;
    }
    row_point<NW, E>(v, X2, Y2);
    return fe_is_zero<NW, E>(Y2);
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
