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
// horner_combine: sum_w 2^(c w) S_w MSB first, c doublings and one add a
// window: (W - 1)(c + 1) group operations in sequence, however the sum is
// arranged, so the bound is latency: the chain's critical path of
// (W - 1)(3 c + 5) dependent base-field products. One CTA runs it; each
// level's independent products run at once, each split over a group of
// lanes (below). It launches 1 block of 160 threads (256 for G2 at
// NW = 12).
//
// dbl_chain: the bases 2^(c w) G, w < W, of a fixed-base window table (the
// scan of libsnark_tpu/ops/msm.py:914-920, one Pallas dbl of c reps a
// window; one single-lane dbl launch a window before this kernel): c (W -
// 1) dependent doublings, so the bound is latency, 3 levels of dependent
// products a doubling. One CTA runs the chain with horner_combine's slots
// and hz_dbl, and stores each base as it is reached.
//
// Instantiated for NW = 8 and NW = 12 words, and for ext = 1 at NW = 24
// (BW6-761's G1 and its G2 over Fp; ext = 2 there is refused). At NW = 24
// a lane group is 32 lanes, 24 of them holding words (LaneGroup<24>::GS),
// so horner_combine runs 160 threads and dbl_chain 96, as at NW = 8.
#include "ec.cuh"

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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

// ---------------------------------------------------------- horner_combine
// One CTA runs the chain. Field elements live in shared memory as slots of
// NW words per component; an Fp2 slot keeps a third component, c0 + c1, the
// Karatsuba operand. The group law is cut into levels: a level's products
// are independent of each other and run at once, each on a group of GS lanes
// (the lane-split product of field.cuh), an Fp2 product as its three
// Karatsuba base products on three groups. A dependent product took 0.445 /
// 0.619 us so at NW = 8 / 12, against 0.525 / 1.181 us in one thread
// (chip_smoke.py's latency probe, NVIDIA H100 80GB HBM3 at 700 W).
// Between two product levels a "task" phase does the additions: task k
// runs on warp k, so tasks do not serialise in one warp, and combines raw
// Karatsuba products (v0, v1, t) into Fp2 values as it loads them. A task
// holds an element one word a lane (every group of the warp on the same
// values, group 0 storing) and adds and subtracts with a carry-lookahead
// over warp votes, as fp_mul_lanes normalises: four votes an operation at
// any width, where a thread's carry chain takes 2 NW dependent steps and
// its reduction as many again. dbl (dbl-2009-l) is 3 levels: {X^2, Y^2,
// YZ}, {B^2, X 4B, E^2}, {E (D - X3)}; add (add-2007-bl with Z3 = 2 Z1 Z2 H)
// is 5: {Z1^2, Z2^2, Z1 Z2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2}, {(2H)^2,
// Z1 Z2 H}, {J, V, rr^2}, {S1 J, rr (V - X3)}. Infinity on either side and
// P == Q are block-uniform branches read from shared memory by every
// thread.

// slots: the accumulator, the window being added, raw products (R*) and
// combined values (N*)
enum HSlot {
  AX, AY, AZ, QX, QY, QZ, R0, R1, R2, R3, R4,
  N0, N1, N2, N3, N4, N5, N6, N7, N8, N9, N10, N11, N12, NSLOT
};

template <int E>
struct HC {
  static constexpr int C = E == 2 ? 3 : 1;   // components of a slot
};

template <int NW, int E>
struct HornerShape {
  static constexpr int GS = LaneGroup<NW>::GS;
  // most base products in one level (add's first: 5 of the field of E),
  // and 5 task warps
  static constexpr int PROD_LANES = 5 * HC<E>::C * GS;
  static constexpr int THREADS =
      PROD_LANES > 160 ? (PROD_LANES + 31) / 32 * 32 : 160;
};

// dbl_chain: dbl's widest level has 3 products, and 3 task warps
template <int NW, int E>
struct DblShape {
  static constexpr int PROD_LANES = 3 * HC<E>::C * LaneGroup<NW>::GS;
  static constexpr int THREADS =
      PROD_LANES > 96 ? (PROD_LANES + 31) / 32 * 32 : 96;
};

template <int NW, int E>
using HSlots = uint32_t[NSLOT][HC<E>::C][NW];

// ---- lane-form arithmetic: lane j of a group of LG lanes holds word j
template <int NW>
struct Ln {
  static constexpr int LG = LaneGroup<NW>::GS;
  static constexpr uint32_t WORDS = (1u << NW) - 1;
  int j;          // word of this lane (junk words in lanes >= NW are 0)
  uint32_t pj;    // word j of p
};

// carry (or borrow) into word j and out of the top word, from the generate
// and propagate masks of the group: the carries of the binary sum G + (G|P)
template <int NW>
__device__ __forceinline__ uint32_t lookahead(uint32_t G, uint32_t P) {
  return G + (G | P);
}

// a + b mod p (canonical in, canonical out)
template <int NW>
__device__ __forceinline__ uint32_t l_add(uint32_t a, uint32_t b,
                                          const Ln<NW>& L) {
  constexpr int LG = Ln<NW>::LG;
  constexpr uint32_t WORDS = Ln<NW>::WORDS;
  uint64_t s = (uint64_t)a + b;
  uint32_t w = (uint32_t)s;
  uint32_t P = group_vote<LG>(w == 0xFFFFFFFFu, WORDS);
  uint32_t C = lookahead<NW>(group_vote<LG>((s >> 32) != 0, WORDS), P);
  w += ((C ^ P) >> L.j) & 1;
  uint32_t BP = group_vote<LG>(w == L.pj, WORDS);
  uint32_t B = lookahead<NW>(group_vote<LG>(w < L.pj, WORDS), BP);
  uint32_t d = w - L.pj - (((B ^ BP) >> L.j) & 1);
  // subtract p on a carry out of the top word or no borrow out of w - p
  return (((C >> NW) & 1) || !((B >> NW) & 1)) ? d : w;
}

// a - b mod p
template <int NW>
__device__ __forceinline__ uint32_t l_sub(uint32_t a, uint32_t b,
                                          const Ln<NW>& L) {
  constexpr int LG = Ln<NW>::LG;
  constexpr uint32_t WORDS = Ln<NW>::WORDS;
  uint32_t BP = group_vote<LG>(a == b, WORDS);
  uint32_t B = lookahead<NW>(group_vote<LG>(a < b, WORDS), BP);
  uint32_t d = a - b - (((B ^ BP) >> L.j) & 1);
  uint64_t s = (uint64_t)d + L.pj;          // d + p, used if a < b
  uint32_t w = (uint32_t)s;
  uint32_t P = group_vote<LG>(w == 0xFFFFFFFFu, WORDS);
  uint32_t C = lookahead<NW>(group_vote<LG>((s >> 32) != 0, WORDS), P);
  w += ((C ^ P) >> L.j) & 1;
  return ((B >> NW) & 1) ? w : d;
}

// k a for 1 <= k <= 8 (double and add, high bit first)
template <int NW>
__device__ __forceinline__ uint32_t l_mul_small(uint32_t a, int k,
                                                const Ln<NW>& L) {
  uint32_t r = a;
  for (int bit = 2; bit >= 0; --bit) {
    if ((k >> (bit + 1)) == 0) continue;    // above k's top bit
    r = l_add<NW>(r, r, L);
    if ((k >> bit) & 1) r = l_add<NW>(r, a, L);
  }
  return r;
}

template <int E>
struct LFe {
  uint32_t c[E];
};

template <int NW, int E>
__device__ __forceinline__ LFe<E> lf_add(const LFe<E>& a, const LFe<E>& b,
                                         const Ln<NW>& L) {
  LFe<E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = l_add<NW>(a.c[c], b.c[c], L);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ LFe<E> lf_sub(const LFe<E>& a, const LFe<E>& b,
                                         const Ln<NW>& L) {
  LFe<E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = l_sub<NW>(a.c[c], b.c[c], L);
  return r;
}

template <int NW, int E>
__device__ __forceinline__ LFe<E> lf_dbl(const LFe<E>& a, const Ln<NW>& L) {
  return lf_add<NW, E>(a, a, L);
}

template <int NW, int E>
__device__ __forceinline__ LFe<E> l_ld(HSlots<NW, E>& S, int s,
                                       const Ln<NW>& L) {
  LFe<E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) r.c[c] = L.j < NW ? S[s][c][L.j] : 0;
  return r;
}

// a raw product slot: Fp as it is; Fp2 (v0, v1, t) -> (v0 + beta v1,
// t - v0 - v1), fe_mul's combine (beta = -beta_small when beta_neg)
template <int NW, int E>
__device__ __forceinline__ LFe<E> l_raw(HSlots<NW, E>& S, int s,
                                        const Ln<NW>& L, const Mod<NW>& M) {
  if constexpr (E == 1) {
    return l_ld<NW, E>(S, s, L);
  } else {
    uint32_t v0 = L.j < NW ? S[s][0][L.j] : 0;
    uint32_t v1 = L.j < NW ? S[s][1][L.j] : 0;
    uint32_t t = L.j < NW ? S[s][2][L.j] : 0;
    uint32_t bv1 = l_mul_small<NW>(v1, M.beta_small, L);
    LFe<E> r;
    r.c[0] = M.beta_neg ? l_sub<NW>(v0, bv1, L) : l_add<NW>(v0, bv1, L);
    r.c[1] = l_sub<NW>(t, l_add<NW>(v0, v1, L), L);
    return r;
  }
}

// store (and, for Fp2, the Karatsuba operand c0 + c1): group 0 of the warp
template <int NW, int E>
__device__ __forceinline__ void l_st(HSlots<NW, E>& S, int s,
                                     const LFe<E>& v, const Ln<NW>& L) {
  uint32_t sum = 0;
  if constexpr (E == 2) sum = l_add<NW>(v.c[0], v.c[1], L);
  if (L.j < NW && (threadIdx.x & 31) < Ln<NW>::LG) {
#pragma unroll
    for (int c = 0; c < E; ++c) S[s][c][L.j] = v.c[c];
    if constexpr (E == 2) S[s][2][L.j] = sum;
  }
}

template <int NW, int E>
__device__ __forceinline__ bool hz_is_zero(HSlots<NW, E>& S, int s) {
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < E; ++c)
#pragma unroll
    for (int k = 0; k < NW; ++k) acc |= S[s][c][k];
  return acc == 0;
}

// One product level: the products (d <- a * b) of the slot triples T, each
// as C base products on groups of GS lanes. Every thread of the block takes
// part (a group past the last product runs the first and stores nothing),
// so each warp's shuffles and votes see all its lanes. The slots are
// template arguments, picked with static indices.
template <int NW, int E, int... T>
__device__ __forceinline__ void hz_products(HSlots<NW, E>& S, const Ln<NW>& L,
                                            const Mod<NW>& M) {
  constexpr int GS = LaneGroup<NW>::GS;
  constexpr int C = HC<E>::C;
  constexpr int NP = sizeof...(T) / 3;
  constexpr int sp[] = {T...};
  const int g = threadIdx.x / GS;
  const bool live = g < NP * C;
  const int k = g / C;
  const int q = live ? g % C : 0;
  int d = sp[0], a = sp[1], b = sp[2];
#pragma unroll
  for (int i = 1; i < NP; ++i)
    if (k == i) {
      d = sp[3 * i];
      a = sp[3 * i + 1];
      b = sp[3 * i + 2];
    }
  static_assert(GS == Ln<NW>::LG, "products and tasks share the groups");
  uint32_t bw[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) bw[i] = S[b][q][i];
  uint32_t aj = L.j < NW ? S[a][q][L.j] : 0;
  uint32_t r = fp_mul_lanes<NW, GS>(aj, bw, L.pj, L.j, M);
  if (live && L.j < NW) S[d][q][L.j] = r;
}

#define TASK(k) if ((threadIdx.x >> 5) == (k))
#define LD(s) l_ld<NW, E>(S, s, L)
#define RAW(s) l_raw<NW, E>(S, s, L, M)
#define ST(s, v) l_st<NW, E>(S, s, v, L)
#define ADD(a, b) lf_add<NW, E>(a, b, L)
#define SUB(a, b) lf_sub<NW, E>(a, b, L)
#define DBL(a) lf_dbl<NW, E>(a, L)

// acc <- 2 acc (dbl-2009-l); uniform over Z = 0. Ends synchronised.
// D = 2 ((X + B)^2 - A - C) is taken as the product X (4B), the same field
// element (so the same limbs): where products run at once, a product costs
// no more than a square, and D then needs no additions after its level.
template <int NW, int E>
__device__ __forceinline__ void hz_dbl(HSlots<NW, E>& S, const Ln<NW>& L,
                                       const Mod<NW>& M) {
  typedef LFe<E> F;
  hz_products<NW, E, R0, AX, AX, R1, AY, AY, R2, AY, AZ>(S, L, M);
  __syncthreads();
  TASK(0) {                                   // E = 3A
    F A = RAW(R0);
    ST(N1, ADD(DBL(A), A));
  }
  TASK(1) {                                   // B, 4B
    F B = RAW(R1);
    ST(N2, B);
    ST(N3, DBL(DBL(B)));
  }
  TASK(2) ST(AZ, DBL(RAW(R2)));
  __syncthreads();
  // C = B^2, D = X 4B, F = E^2
  hz_products<NW, E, R0, N2, N2, R1, AX, N3, R2, N1, N1>(S, L, M);
  __syncthreads();
  TASK(0) {                                   // X3, D - X3
    F D = RAW(R1);
    F X3 = SUB(RAW(R2), DBL(D));
    ST(AX, X3);
    ST(N4, SUB(D, X3));
  }
  TASK(1) ST(N5, DBL(DBL(DBL(RAW(R0)))));     // 8 C
  __syncthreads();
  hz_products<NW, E, R0, N1, N4>(S, L, M);
  __syncthreads();
  TASK(0) ST(AY, SUB(RAW(R0), LD(N5)));
  __syncthreads();
}

// acc <- acc + Q (add-2007-bl, as ec_add): infinity on either side returns
// the other (acc's first), P == Q doubles acc. Starts and ends synchronised.
template <int NW, int E>
__device__ __forceinline__ void hz_add(HSlots<NW, E>& S, const Ln<NW>& L,
                                       const Mod<NW>& M) {
  typedef LFe<E> F;
  if (hz_is_zero<NW, E>(S, AZ)) {
    __syncthreads();                          // every thread has read AZ
    TASK(0) ST(AX, LD(QX));
    TASK(1) ST(AY, LD(QY));
    TASK(2) ST(AZ, LD(QZ));
    __syncthreads();
    return;
  }
  if (hz_is_zero<NW, E>(S, QZ)) return;
  // Z1Z1, Z2Z2, Z1 Z2, Y1 Z2, Y2 Z1
  hz_products<NW, E, R0, AZ, AZ, R1, QZ, QZ, R2, AZ, QZ,
              R3, AY, QZ, R4, QY, AZ>(S, L, M);
  __syncthreads();
  TASK(0) ST(N0, RAW(R0));
  TASK(1) ST(N1, RAW(R1));
  TASK(2) ST(N2, RAW(R2));
  TASK(3) ST(N3, RAW(R3));
  TASK(4) ST(N4, RAW(R4));
  __syncthreads();
  // U2 = X2 Z1Z1, U1 = X1 Z2Z2, S1 = Y1Z2 Z2Z2, S2 = Y2Z1 Z1Z1
  hz_products<NW, E, R0, QX, N0, R1, AX, N1,
              R2, N3, N1, R3, N4, N0>(S, L, M);
  __syncthreads();
  TASK(0) {                                   // H, 2H, U1
    F U1 = RAW(R1);
    F H = SUB(RAW(R0), U1);
    ST(N5, H);
    ST(N6, DBL(H));
    ST(N7, U1);
  }
  TASK(1) {                                   // rr = 2 (S2 - S1), S1
    F S1 = RAW(R2);
    ST(N8, DBL(SUB(RAW(R3), S1)));
    ST(N9, S1);
  }
  __syncthreads();
  if (hz_is_zero<NW, E>(S, N5) && hz_is_zero<NW, E>(S, N8)) {
    hz_dbl<NW, E>(S, L, M);               // P == Q: acc is untouched
    return;
  }
  // I = (2H)^2, Z1 Z2 H
  hz_products<NW, E, R0, N6, N6, R1, N2, N5>(S, L, M);
  __syncthreads();
  TASK(0) ST(N10, RAW(R0));
  TASK(1) ST(AZ, DBL(RAW(R1)));
  __syncthreads();
  // J = H I, V = U1 I, rr^2
  hz_products<NW, E, R0, N5, N10, R1, N7, N10, R2, N8, N8>(S, L, M);
  __syncthreads();
  TASK(0) {                                   // X3, V - X3, J
    F J = RAW(R0);
    F V = RAW(R1);
    F X3 = SUB(SUB(RAW(R2), J), DBL(V));
    ST(AX, X3);
    ST(N11, SUB(V, X3));
    ST(N12, J);
  }
  __syncthreads();
  // S1 J, rr (V - X3)
  hz_products<NW, E, R0, N9, N12, R1, N8, N11>(S, L, M);
  __syncthreads();
  TASK(0) ST(AY, SUB(RAW(R1), DBL(RAW(R0))));
  __syncthreads();
}

// coordinate i of window w from the (E 2 NW, W) limb layout, lane form
template <int NW, int E>
__device__ __forceinline__ LFe<E> l_gload(const int32_t* src, int64_t W,
                                          int64_t w, const Ln<NW>& L) {
  LFe<E> r;
#pragma unroll
  for (int c = 0; c < E; ++c) {
    r.c[c] = 0;
    if (L.j < NW) {
      const int32_t* base = src + (int64_t)(c * 2 * NW + 2 * L.j) * W + w;
      r.c[c] = ((uint32_t)base[0] & 0xFFFFu) | ((uint32_t)base[W] << 16);
    }
  }
  return r;
}

// sum_w 2^(c w) S_w, MSB first: c doublings and one add a window.
template <int NW, int E>
__global__ void __launch_bounds__(HornerShape<NW, E>::THREADS, 1)
horner_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
              const int32_t* __restrict__ sz, int64_t W, int c, int32_t* ox,
              int32_t* oy, int32_t* oz, const __grid_constant__ Mod<NW> M) {
  __shared__ HSlots<NW, E> S;
  // coordinate i's pointers, selected (an array of them took a stack frame)
  auto src = [&](int i) { return i == 0 ? sx : i == 1 ? sy : sz; };
  auto dst = [&](int i) { return i == 0 ? ox : i == 1 ? oy : oz; };
  Ln<NW> L;
  L.j = threadIdx.x % Ln<NW>::LG;
  L.pj = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k == L.j) L.pj = M.p[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    TASK(i) ST(AX + i, (l_gload<NW, E>(src(i), W, W - 1, L)));
  __syncthreads();
  for (int64_t w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) hz_dbl<NW, E>(S, L, M);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      TASK(i) ST(QX + i, (l_gload<NW, E>(src(i), W, w, L)));
    __syncthreads();
    hz_add<NW, E>(S, L, M);
  }
  // lane j of warp i writes word j of coordinate i
#pragma unroll
  for (int i = 0; i < 3; ++i)
    TASK(i) if (L.j < NW && (threadIdx.x & 31) < Ln<NW>::LG) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        uint32_t v = S[AX + i][e][L.j];
        dst(i)[e * 2 * NW + 2 * L.j] = (int32_t)(v & 0xFFFFu);
        dst(i)[e * 2 * NW + 2 * L.j + 1] = (int32_t)(v >> 16);
      }
    }
}
// the bases of a window table: g_0 = P, g_(w+1) = 2^c g_w; g_w goes to
// column w of the (E 2 NW, W) limb layout as soon as it is reached
template <int NW, int E>
__global__ void __launch_bounds__(DblShape<NW, E>::THREADS, 1)
dbl_chain_kernel(const int32_t* __restrict__ px,
                 const int32_t* __restrict__ py,
                 const int32_t* __restrict__ pz, int W, int c, int32_t* ox,
                 int32_t* oy, int32_t* oz, const __grid_constant__ Mod<NW> M) {
  __shared__ HSlots<NW, E> S;
  auto src = [&](int i) { return i == 0 ? px : i == 1 ? py : pz; };
  auto dst = [&](int i) { return i == 0 ? ox : i == 1 ? oy : oz; };
  Ln<NW> L;
  L.j = threadIdx.x % Ln<NW>::LG;
  L.pj = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k == L.j) L.pj = M.p[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    TASK(i) ST(AX + i, (l_gload<NW, E>(src(i), 1, 0, L)));
  __syncthreads();
  for (int w = 0; w < W; ++w) {
    // lane j of warp i writes word j of coordinate i; the next hz_dbl
    // writes the accumulator only after its first barrier
#pragma unroll
    for (int i = 0; i < 3; ++i)
      TASK(i) if (L.j < NW && (threadIdx.x & 31) < Ln<NW>::LG) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          uint32_t v = S[AX + i][e][L.j];
          int32_t* o = dst(i) + (int64_t)(e * 2 * NW + 2 * L.j) * W + w;
          o[0] = (int32_t)(v & 0xFFFFu);
          o[W] = (int32_t)(v >> 16);
        }
      }
    if (w + 1 < W)
      for (int k = 0; k < c; ++k) hz_dbl<NW, E>(S, L, M);
  }
}
#undef TASK
#undef LD
#undef RAW
#undef ST
#undef ADD
#undef SUB
#undef DBL

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
// a width built for ext = 1 only (lsn_built refuses ext = 2 there)
#define LAUNCH_W1(NWV, KERNEL, GRID, THREADS, ...)                           \
  case NWV:                                                                  \
    KERNEL<NWV, 1><<<GRID, THREADS, 0, s>>>(__VA_ARGS__,                     \
                                            *(const Mod<NWV>*)M);            \
    break;
#define LAUNCH(KERNEL, GRID, THREADS, ...)                                   \
  switch (nw) {                                                              \
    LAUNCH_W(8, KERNEL, GRID, THREADS, __VA_ARGS__)                          \
    LAUNCH_W(12, KERNEL, GRID, THREADS, __VA_ARGS__)                         \
    LAUNCH_W1(24, KERNEL, GRID, THREADS, __VA_ARGS__)                        \
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
  if (!lsn_built(nw, ext)) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned grid = (unsigned)((nb + 127) / 128);
    LAUNCH(bucket_reduce_kernel, grid, 128, (const uint4*)rows, m, I32(gidx),
           I64(starts), I32(counts), I64(order), nb, O32(ox), O32(oy),
           O32(oz))
  }
  return (int)cudaGetLastError();
}

template <int NW, int E>
static void horner_launch(const void* sx, const void* sy, const void* sz,
                          long long W, int c, void* ox, void* oy, void* oz,
                          const void* M, cudaStream_t s) {
  horner_kernel<NW, E><<<1, HornerShape<NW, E>::THREADS, 0, s>>>(
      I32(sx), I32(sy), I32(sz), W, c, O32(ox), O32(oy), O32(oz),
      *(const Mod<NW>*)M);
}

extern "C" int lsn_horner(int nw, int ext, const void* sx, const void* sy,
                          const void* sz, long long W, int c, void* ox,
                          void* oy, void* oz, const void* M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1 || c < 0 || !lsn_built(nw, ext))
    return (int)cudaErrorInvalidValue;
  if (nw == 8)
    (ext == 1 ? horner_launch<8, 1> : horner_launch<8, 2>)(
        sx, sy, sz, W, c, ox, oy, oz, M, s);
  else if (nw == 12)
    (ext == 1 ? horner_launch<12, 1> : horner_launch<12, 2>)(
        sx, sy, sz, W, c, ox, oy, oz, M, s);
  else
    horner_launch<24, 1>(sx, sy, sz, W, c, ox, oy, oz, M, s);
  return (int)cudaGetLastError();
}

template <int NW, int E>
static void dbl_chain_launch(const void* px, const void* py, const void* pz,
                             int W, int c, void* ox, void* oy, void* oz,
                             const void* M, cudaStream_t s) {
  dbl_chain_kernel<NW, E><<<1, DblShape<NW, E>::THREADS, 0, s>>>(
      I32(px), I32(py), I32(pz), W, c, O32(ox), O32(oy), O32(oz),
      *(const Mod<NW>*)M);
}

// p*: one Jacobian point, (2 ext nw, 1) limbs a coordinate; o*: (2 ext nw,
// W) limbs, column w = 2^(c w) P
extern "C" int lsn_dbl_chain(int nw, int ext, const void* px, const void* py,
                             const void* pz, int W, int c, void* ox, void* oy,
                             void* oz, const void* M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1 || c < 0 || !lsn_built(nw, ext))
    return (int)cudaErrorInvalidValue;
  if (nw == 8)
    (ext == 1 ? dbl_chain_launch<8, 1> : dbl_chain_launch<8, 2>)(
        px, py, pz, W, c, ox, oy, oz, M, s);
  else if (nw == 12)
    (ext == 1 ? dbl_chain_launch<12, 1> : dbl_chain_launch<12, 2>)(
        px, py, pz, W, c, ox, oy, oz, M, s);
  else
    dbl_chain_launch<24, 1>(px, py, pz, W, c, ox, oy, oz, M, s);
  return (int)cudaGetLastError();
}