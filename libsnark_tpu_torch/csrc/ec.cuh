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
  F U2 = fe_mul(X2, Z1Z1, M);
  F S2 = fe_mul(fe_mul(Y2, P.Z, M), Z1Z1, M);
  F H = fe_sub<NW, E>(U2, P.X, M);
  F rr = fe_dbl<NW, E>(fe_sub<NW, E>(S2, P.Y, M), M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) return ec_dbl<NW, E>(P, M);
  F HH = fe_sqr<NW, E>(H, M);
  F I = fe_dbl<NW, E>(fe_dbl<NW, E>(HH, M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(P.X, I, M);
  Jac<NW, E> R;
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(fe_mul(P.Y, J, M), M), M);
  R.Z = fe_sub<NW, E>(
      fe_sub<NW, E>(fe_sqr<NW, E>(fe_add<NW, E>(P.Z, H, M), M), Z1Z1, M), HH, M);
  return R;
}

// add-2007-bl: both Jacobian; infinity on either side returns the other.
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_add(const Jac<NW, E>& P,
                                             const Jac<NW, E>& Q,
                                             const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  if (fe_is_zero<NW, E>(P.Z)) return Q;
  if (fe_is_zero<NW, E>(Q.Z)) return P;
  F Z1Z1 = fe_sqr<NW, E>(P.Z, M);
  F Z2Z2 = fe_sqr<NW, E>(Q.Z, M);
  F U1 = fe_mul(P.X, Z2Z2, M);
  F U2 = fe_mul(Q.X, Z1Z1, M);
  F S1 = fe_mul(fe_mul(P.Y, Q.Z, M), Z2Z2, M);
  F S2 = fe_mul(fe_mul(Q.Y, P.Z, M), Z1Z1, M);
  F H = fe_sub<NW, E>(U2, U1, M);
  F rr = fe_dbl<NW, E>(fe_sub<NW, E>(S2, S1, M), M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) return ec_dbl<NW, E>(P, M);
  F I = fe_sqr<NW, E>(fe_dbl<NW, E>(H, M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(U1, I, M);
  Jac<NW, E> R;
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(fe_mul(S1, J, M), M), M);
  R.Z = fe_mul(
      fe_sub<NW, E>(
          fe_sub<NW, E>(fe_sqr<NW, E>(fe_add<NW, E>(P.Z, Q.Z, M), M), Z1Z1, M),
          Z2Z2, M),
      H, M);
  return R;
}

// mmadd-2007-bl: both affine (Z1 = Z2 = 1), six products. Infinity masks
// in the order of _ec_aadd_flag (pallas_ec.py:195-203): i2 lifts P, then
// i1 lifts Q, and both give (x2, y2, 0). P == Q doubles (x1, y1, one), as
// the TPU wrapper's repair does; P == -Q falls out of the formula as
// (rr^2, -rr^3, 0).
template <int NW, int E>
__device__ __forceinline__ Jac<NW, E> ec_aadd(const Fe<NW, E>& X1,
                                              const Fe<NW, E>& Y1, bool i1,
                                              const Fe<NW, E>& X2,
                                              const Fe<NW, E>& Y2, bool i2,
                                              const Mod<NW>& M) {
  typedef Fe<NW, E> F;
  Jac<NW, E> R;
  if (i1 || i2) {
    R.X = i1 ? X2 : X1;
    R.Y = i1 ? Y2 : Y1;
    R.Z = (i1 && i2) ? fe_zero<NW, E>() : fe_one<NW, E>(M);
    return R;
  }
  F H = fe_sub<NW, E>(X2, X1, M);
  F rr = fe_dbl<NW, E>(fe_sub<NW, E>(Y2, Y1, M), M);
  if (fe_is_zero<NW, E>(H) && fe_is_zero<NW, E>(rr)) {
    R.X = X1;
    R.Y = Y1;
    R.Z = fe_one<NW, E>(M);
    return ec_dbl<NW, E>(R, M);
  }
  F HH = fe_sqr<NW, E>(H, M);
  F I = fe_dbl<NW, E>(fe_dbl<NW, E>(HH, M), M);
  F J = fe_mul(H, I, M);
  F V = fe_mul(X1, I, M);
  R.X = fe_sub<NW, E>(fe_sub<NW, E>(fe_sqr<NW, E>(rr, M), J, M),
                      fe_dbl<NW, E>(V, M), M);
  R.Y = fe_sub<NW, E>(fe_mul(rr, fe_sub<NW, E>(V, R.X, M), M),
                      fe_dbl<NW, E>(fe_mul(Y1, J, M), M), M);
  R.Z = fe_dbl<NW, E>(H, M);
  return R;
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
