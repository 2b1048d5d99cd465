// Jacobian group law for a = 0 short-Weierstrass curves over Fp (E = 1,
// G1) and Fp2 (E = 2, G2), for a base field of NW 32-bit words: the
// formulas of libsnark_tpu/ops/pallas_ec.py (_ec_dbl, _ec_madd_flag,
// _ec_add_flag, _ec_aadd_flag), one point per thread.
//
// On the TPU the add kernels return a need-double flag and the wrapper
// repairs flagged lanes with a second dbl launch under a lax.cond
// (_dbl_repair, pallas_ec.py:421-440). Here the repair is a branch inside
// the thread: a lane with P == Q takes dbl(P) and no other lane pays for
// it. The result equals the JAX semantics lane for lane.
#pragma once
#include "field.cuh"

// __launch_bounds__ minimum blocks of 128 threads per SM of add_kernel,
// madd_kernel, madd_windows_kernel, bucket_reduce_kernel, aadd_kernel and
// aadd_rows_kernel (one value, Blocks::aadd) and dbl_kernel: it sets
// ptxas's register budget at 65536 / (128 blocks) per thread (4: 128
// registers, 3: 168, 2 and 1: 255). G2 add and bucket_reduce take 1 (their
// products are called functions and they sit at the 255 cap whatever the
// budget). The values are the fastest budgets at which ptxas spills
// nothing in scripts/sweep_launch_bounds.py's runs on an H100 (ptxas then
// takes add 162 / 220 registers at 16 / 24 limbs, bucket_reduce 107 / 149;
// one block more spilled add 88 / 108 B and bucket_reduce 84 B at 24
// limbs). madd and madd_windows take no budget below 255 registers (madd
// 106 / 147, G2 192 / 255; madd_windows 102 / 145, G2 168 at 16 limbs),
// except madd_windows for G2 at 24 limbs: at 3 blocks it spills 1.4 KB
// and still ran faster than at 255 registers without spills.
// aadd_kernel and aadd_rows_kernel share Blocks::aadd: G1 4 / 3 blocks at
// 16 / 24 limbs (aadd 123 / 166 registers, aadd_rows 96 / 138, no spills;
// no budget moved either's time), G2 1 at 16 limbs (188 / 164 registers,
// no spills) and 3 at 24 limbs (168 registers: aadd_rows spills 1000 B and
// ran 9.8 ms against 12.3 at 238 registers without spills on a 2^20-point
// MSM's dense chunk; aadd spills 1220 B and ran 10 % slower than at 255
// registers, but aadd_rows is the one on a path). dbl_kernel: G1 4 / 3
// (88 / 128 registers), G2 1 (148 / 227; 4 blocks ran G2 at 16 limbs 5-7 %
// faster with 140 B of spills, and the public dbl runs on no path).
// At 48 limbs (NW = 24, ext = 1 only: BW6-761's G1 and G2) a point has
// coordinates of 24 words, the register load of G2 at 24 limbs, and the
// budgets follow the path: madd_windows 3 blocks and bucket_reduce 3
// (2-5 % faster than at 1 block, 255 registers, on an H100 at 2^20 lanes
// and on a 2^20-point MSM, and over the BW6-761 keygen and prove), add 3
// (3.5 % faster at 294,930 lanes, a level of the segment combine; even
// over the proves); two builds at 1 block differed by 0.3 % at most, and
// the three spill 1.4-2.2 KB. aadd_rows takes 1 block (214 registers, no
// spills): at 4 blocks it ran a 2^20-point dense chunk 7 % faster but the
// BW6-761 dense prove's 45 launches 25 % slower. madd and dbl run on no
// path at 48 limbs and take 1 block, the fastest at the checks' 2^16
// lanes (madd 253 registers, dbl 214, no spills).
// The sweep's builds set them with -D.
#ifndef LSN_ADD_BLOCKS_N16
#define LSN_ADD_BLOCKS_N16 3
#endif
#ifndef LSN_ADD_BLOCKS_N24
#define LSN_ADD_BLOCKS_N24 2
#endif
#ifndef LSN_MADD_BLOCKS_N16
#define LSN_MADD_BLOCKS_N16 1
#endif
#ifndef LSN_MADD_BLOCKS_N24
#define LSN_MADD_BLOCKS_N24 1
#endif
#ifndef LSN_MADD_BLOCKS_G2
#define LSN_MADD_BLOCKS_G2 1
#endif
#ifndef LSN_MADD_WIN_BLOCKS_N16
#define LSN_MADD_WIN_BLOCKS_N16 1
#endif
#ifndef LSN_MADD_WIN_BLOCKS_N24
#define LSN_MADD_WIN_BLOCKS_N24 1
#endif
#ifndef LSN_MADD_WIN_BLOCKS_G2_N16
#define LSN_MADD_WIN_BLOCKS_G2_N16 1
#endif
#ifndef LSN_MADD_WIN_BLOCKS_G2_N24
#define LSN_MADD_WIN_BLOCKS_G2_N24 3
#endif
#ifndef LSN_BUCKET_BLOCKS_N16
#define LSN_BUCKET_BLOCKS_N16 4
#endif
#ifndef LSN_BUCKET_BLOCKS_N24
#define LSN_BUCKET_BLOCKS_N24 3
#endif
#ifndef LSN_AADD_BLOCKS_N16
#define LSN_AADD_BLOCKS_N16 4
#endif
#ifndef LSN_AADD_BLOCKS_N24
#define LSN_AADD_BLOCKS_N24 3
#endif
#ifndef LSN_AADD_BLOCKS_G2_N16
#define LSN_AADD_BLOCKS_G2_N16 1
#endif
#ifndef LSN_AADD_BLOCKS_G2_N24
#define LSN_AADD_BLOCKS_G2_N24 3
#endif
#ifndef LSN_DBL_BLOCKS_N16
#define LSN_DBL_BLOCKS_N16 4
#endif
#ifndef LSN_DBL_BLOCKS_N24
#define LSN_DBL_BLOCKS_N24 3
#endif
#ifndef LSN_DBL_BLOCKS_G2
#define LSN_DBL_BLOCKS_G2 1
#endif

#ifndef LSN_ADD_BLOCKS_N48
#define LSN_ADD_BLOCKS_N48 3
#endif
#ifndef LSN_MADD_BLOCKS_N48
#define LSN_MADD_BLOCKS_N48 1
#endif
#ifndef LSN_MADD_WIN_BLOCKS_N48
#define LSN_MADD_WIN_BLOCKS_N48 3
#endif
#ifndef LSN_BUCKET_BLOCKS_N48
#define LSN_BUCKET_BLOCKS_N48 3
#endif
#ifndef LSN_AADD_BLOCKS_N48
#define LSN_AADD_BLOCKS_N48 1
#endif
#ifndef LSN_DBL_BLOCKS_N48
#define LSN_DBL_BLOCKS_N48 1
#endif

// ext = 1 budgets by width: n16 at NW = 8, n24 at NW = 12, n48 at NW = 24
#define LSN_BY_NW(NWV, n16, n24, n48) \
  ((NWV) == 8 ? (n16) : (NWV) == 12 ? (n24) : (n48))

template <int NW, int E>
struct Blocks {
  static constexpr int add =
      E == 2 ? 1
             : LSN_BY_NW(NW, LSN_ADD_BLOCKS_N16, LSN_ADD_BLOCKS_N24,
                         LSN_ADD_BLOCKS_N48);
  static constexpr int madd =
      E == 2 ? LSN_MADD_BLOCKS_G2
             : LSN_BY_NW(NW, LSN_MADD_BLOCKS_N16, LSN_MADD_BLOCKS_N24,
                         LSN_MADD_BLOCKS_N48);
  static constexpr int madd_win =
      E == 2 ? (NW == 8 ? LSN_MADD_WIN_BLOCKS_G2_N16 : LSN_MADD_WIN_BLOCKS_G2_N24)
             : LSN_BY_NW(NW, LSN_MADD_WIN_BLOCKS_N16, LSN_MADD_WIN_BLOCKS_N24,
                         LSN_MADD_WIN_BLOCKS_N48);
  static constexpr int bucket =
      E == 2 ? 1
             : LSN_BY_NW(NW, LSN_BUCKET_BLOCKS_N16, LSN_BUCKET_BLOCKS_N24,
                         LSN_BUCKET_BLOCKS_N48);
  static constexpr int aadd =
      E == 2 ? (NW == 8 ? LSN_AADD_BLOCKS_G2_N16 : LSN_AADD_BLOCKS_G2_N24)
             : LSN_BY_NW(NW, LSN_AADD_BLOCKS_N16, LSN_AADD_BLOCKS_N24,
                         LSN_AADD_BLOCKS_N48);
  static constexpr int dbl =
      E == 2 ? LSN_DBL_BLOCKS_G2
             : LSN_BY_NW(NW, LSN_DBL_BLOCKS_N16, LSN_DBL_BLOCKS_N24,
                         LSN_DBL_BLOCKS_N48);
};

// the (width, coordinate field) pairs ec.cu and bucket.cu build: ext 1
// and 2 at NW = 8 and 12, ext 1 only at NW = 24 (no curve of either
// package has an Fp2 over a 761-bit field); their C entries refuse others
static inline bool lsn_built(int nw, int ext) {
  return ext == 1 ? (nw == 8 || nw == 12 || nw == 24)
                  : ext == 2 && (nw == 8 || nw == 12);
}

template <int NW, int E>
struct Jac {
  Fe<NW, E> X, Y, Z;
};

// dbl-2009-l (a = 0); uniform over Z = 0 (keeps Z = 0)
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_dbl(const Jac<NW, E>& P,
                                             const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  F A = fe_sqr<NW, E>(P.X, M);
  F B = fe_sqr<NW, E>(P.Y, M);
  F C = fe_sqr<NW, E>(B, M);
  F t = fe_sqr<NW, E>(fe_add<NW, E>(P.X, B, M), M);
  F D = fe_dbl<NW, E>(fe_sub<NW, E>(fe_sub<NW, E>(t, A, M), C, M), M);
  F Ee = fe_add<NW, E>(fe_add<NW, E>(A, A, M), A, M);
  F Fq = fe_sqr<NW, E>(Ee, M);
  Jac<NW, E> R;
  R.X = fe_sub<NW, E>(Fq, fe_dbl<NW, E>(D, M), M);
  F eight_c = fe_dbl<NW, E>(fe_dbl<NW, E>(fe_dbl<NW, E>(C, M), M), M);
  R.Y = fe_sub<NW, E>(fe_mul(Ee, fe_sub<NW, E>(D, R.X, M), M), eight_c, M);
  R.Z = fe_dbl<NW, E>(fe_mul(P.Y, P.Z, M), M);
  return R;
}

// Register budget. A product keeps about 2 NW + 4 words of its own live
// beside its operands, so a kernel's registers are set by how many field
// elements are live at once. The formulas below are ordered so that every
// value dies at its last use and at most six elements of the result's
// field are live beside a product. Z3 is computed as 2 Z1 H (madd) and
// 2 Z1 Z2 H (add): the same field element as the (Z1 + H)^2 - Z1Z1 - HH
// and ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H of the plain formulas, with as many
// products and without Z1Z1 and Z2Z2 to the end; values are canonical,
// so the limbs are the same.

// madd-2007-bl: P Jacobian + Q affine (X2, Y2); q_inf / !valid keep P.
// P == Q (as group elements, P finite, Q live) is repaired in-thread.
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_madd(const Jac<NW, E>& P,
                                              const Fe<NW, E>& X2,
                                              const Fe<NW, E>& Y2, bool q_inf,
                                              bool valid, const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  bool skip = q_inf || !valid;
  if (skip) return P;
  if (fe_is_zero<NW, E>(P.Z)) {
    Jac<NW, E> R;
    R.X = X2;
    R.Y = Y2;
    R.Z = fe_one<NW, E>(M);
    return R;
  }
  F Z1Z1 = fe_sqr<NW, E>(P.Z, M);
  F H = fe_sub<NW, E>(fe_mul(X2, Z1Z1, M), P.X, M);
  F rr = fe_dbl<NW, E>(
      fe_sub<NW, E>(fe_mul(fe_mul(Y2, P.Z, M), Z1Z1, M), P.Y, M), M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) return ec_dbl<NW, E>(P, M);
  Jac<NW, E> R;
  R.Z = fe_dbl<NW, E>(fe_mul(P.Z, H, M), M);
  F I = fe_dbl<NW, E>(fe_dbl<NW, E>(fe_sqr<NW, E>(H, M), M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(P.X, I, M);
  F YJ = fe_mul(P.Y, J, M);
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(YJ, M), M);
  return R;
}

// add-2007-bl for finite P and Q (Z1, Z2 != 0); Z1 and Z2 die in Z1 Z2
// before the P == Q test. Returns false, with R unset, if P == Q: the
// caller doubles P, which it holds or loads again.
template <int NW, int E>
__device__ __forceinline__ bool ec_add_finite(
    const Fe<NW, E>& X1, const Fe<NW, E>& Y1, const Fe<NW, E>& Z1,
    const Fe<NW, E>& X2, const Fe<NW, E>& Y2, const Fe<NW, E>& Z2,
    Jac<NW, E>& R, const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  F Z2Z2 = fe_sqr<NW, E>(Z2, M);
  F U1 = fe_mul(X1, Z2Z2, M);
  F S1 = fe_mul(fe_mul(Y1, Z2, M), Z2Z2, M);
  F Z1Z1 = fe_sqr<NW, E>(Z1, M);
  F H = fe_sub<NW, E>(fe_mul(X2, Z1Z1, M), U1, M);
  F rr = fe_dbl<NW, E>(
      fe_sub<NW, E>(fe_mul(fe_mul(Y2, Z1, M), Z1Z1, M), S1, M), M);
  F ZZ = fe_mul(Z1, Z2, M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) return false;
  R.Z = fe_dbl<NW, E>(fe_mul(ZZ, H, M), M);
  F I = fe_sqr<NW, E>(fe_dbl<NW, E>(H, M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(U1, I, M);
  F SJ = fe_mul(S1, J, M);
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(SJ, M), M);
  return true;
}

// add-2007-bl: both Jacobian; infinity on either side returns the other.
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_add(const Jac<NW, E>& P,
                                             const Jac<NW, E>& Q,
                                             const Mod<NW>& M) {
  if (fe_is_zero<NW, E>(P.Z)) return Q;
  if (fe_is_zero<NW, E>(Q.Z)) return P;
  Jac<NW, E> R;
  if (!ec_add_finite<NW, E>(P.X, P.Y, P.Z, Q.X, Q.Y, Q.Z, R, M))
    return ec_dbl<NW, E>(P, M);
  return R;
}

// mmadd-2007-bl, both operands affine (Z1 = Z2 = 1): the infinity cases
// first, in the order of _ec_aadd_flag (pallas_ec.py:195-203): i2 lifts P,
// then i1 lifts Q, and both give (x2, y2, 0).
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_aadd_inf(const Fe<NW, E>& X1,
                                                  const Fe<NW, E>& Y1, bool i1,
                                                  const Fe<NW, E>& X2,
                                                  const Fe<NW, E>& Y2, bool i2,
                                                  const Mod<NW>& M) {
  Jac<NW, E> R;
  R.X = i1 ? X2 : X1;
  R.Y = i1 ? Y2 : Y1;
  R.Z = (i1 && i2) ? fe_zero<NW, E>() : fe_one<NW, E>(M);
  return R;
}

// The formula for finite P and Q, six products. Returns false, with R
// unset, if P == Q: the caller doubles (x1, y1, one), as the TPU wrapper's
// repair does, from a second load of P (ec_aadd_repair), so that no value
// of the formula is live across the doubling. P == -Q falls out of the
// formula as (rr^2, -rr^3, 0).
template <int NW, int E>
__device__ __forceinline__ bool ec_aadd_finite(const Fe<NW, E>& X1,
                                               const Fe<NW, E>& Y1,
                                               const Fe<NW, E>& X2,
                                               const Fe<NW, E>& Y2,
                                               Jac<NW, E>& R,
                                               const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  F H = fe_sub<NW, E>(X2, X1, M);
  F rr = fe_dbl<NW, E>(fe_sub<NW, E>(Y2, Y1, M), M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) return false;
  F I = fe_dbl<NW, E>(fe_dbl<NW, E>(fe_sqr<NW, E>(H, M), M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(X1, I, M);
  R.Z = fe_dbl<NW, E>(H, M);
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(fe_mul(Y1, J, M), M), M);
  return true;
}

// the P == Q repair of aadd: dbl(x1, y1, one)
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_aadd_repair(const Fe<NW, E>& X1,
                                                     const Fe<NW, E>& Y1,
                                                     const Mod<NW>& M) {
  Jac<NW, E> P;
  P.X = X1;
  P.Y = Y1;
  P.Z = fe_one<NW, E>(M);
  return ec_dbl<NW, E>(P, M);
}

template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> jac_load(const int32_t* x,
                                               const int32_t* y,
                                               const int32_t* z, int64_t L,
                                               int64_t i) {
  Jac<NW, E> P;
  P.X = fe_load<NW, E>(x, L, i);
  P.Y = fe_load<NW, E>(y, L, i);
  P.Z = fe_load<NW, E>(z, L, i);
  return P;
}

template <int NW, int E>
__device__ __forceinline__ void jac_store(int32_t* x, int32_t* y, int32_t* z,
                                          int64_t L, int64_t i,
                                          const Jac<NW, E>& P) {
  fe_store<NW, E>(x, L, i, P.X);
  fe_store<NW, E>(y, L, i, P.Y);
  fe_store<NW, E>(z, L, i, P.Z);
}

// the E NW words of x and of y from a row's 2 E NW words (a row of the
// packed row table of ops/msm.py row_table: x then y, the register layout)
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

// row gi of a packed row table of Q = E NW / 2 16-byte pieces a row, read
// through the read-only cache; returns whether it is infinity (y == 0)
template <int NW, int E>
__device__ __forceinline__ bool row_fetch(const uint4* __restrict__ rows,
                                          int64_t gi, Fe<NW, E>& X,
                                          Fe<NW, E>& Y) {
  constexpr int Q = E * NW / 2;
  const uint4* row = rows + gi * Q;
  uint32_t v[4 * Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    uint4 p = __ldg(row + q);
    v[4 * q] = p.x; v[4 * q + 1] = p.y; v[4 * q + 2] = p.z; v[4 * q + 3] = p.w;
  }
  row_point<NW, E>(v, X, Y);
  return fe_is_zero<NW, E>(Y);
}

// the same row again, through volatile loads, for the rare P == Q repair:
// the compiler cannot reuse the words loaded for the formula, so those die
// at their last use there and not at the repair
template <int NW, int E>
__device__ __forceinline__ void row_fetch_again(const uint4* rows, int64_t gi,
                                                Fe<NW, E>& X, Fe<NW, E>& Y) {
  constexpr int Q = E * NW / 2;
  const volatile uint32_t* row = (const volatile uint32_t*)(rows + gi * Q);
  uint32_t v[4 * Q];
#pragma unroll
  for (int k = 0; k < 4 * Q; ++k) v[k] = row[k];
  row_point<NW, E>(v, X, Y);
}
