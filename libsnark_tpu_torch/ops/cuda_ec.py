"""Elementwise Jacobian group ops: the CUDA kernels and their plain versions.

Replace the Pallas TPU kernels ``libsnark_tpu/ops/pallas_ec.py:_build_dbl``
(``dbl``), ``_build_add`` (``add``), ``_build_madd`` (``madd``) and
``_build_aadd`` (``aadd``), for G1 (coordinates over Fp, ext = 1) and G2
(over Fp2, ext = 2), a = 0 curves, at every built field width.

The kernels (csrc/ec.cu over csrc/ec.cuh) run one thread per lane. What
bounds them on the card: the field products (aadd 6, dbl 7, madd 11, add
16 per lane for G1; three base products per Fp2 product for G2), i.e. 32-bit
integer multiply throughput; each lane's limbs are read and written once
and every coordinate stays in registers. The P == Q repair, which the TPU
wrapper runs as a second dbl launch under a lax.cond (``_dbl_repair``,
pallas_ec.py:421-440), is a branch inside the thread; the lane gets dbl(P)
exactly as in the JAX semantics.

The plain versions below compute the same formulas with torch ops over a
field kernel whose products are plain (``fk.as_plain()``). The wrappers take
them only for CPU tensors; CUDA tensors always launch the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

def counter_keys(kernels):
    """Launch-counter keys: one per kernel, coordinate field (fp: G1, fp2:
    G2) and field width (N 16-bit limbs)."""
    return [f"{k}_{f}_n{2 * nw}" for k in kernels for f in ("fp", "fp2")
            for nw in cuda_lib.WIDTHS]


LAUNCHES = dict.fromkeys(counter_keys(("dbl", "add", "madd", "aadd")), 0)


def ext_of(fk) -> int:
    """Coordinate field degree: 2 for an Fp2Kernel, 1 for an FpKernel."""
    return 2 if hasattr(fk, "fp") else 1


def counter_key(kernel: str, fk) -> str:
    return f"{kernel}_{'fp2' if ext_of(fk) == 2 else 'fp'}_n{fk.N}"


# --------------------------------------------------------------- formulas

def dbl_formula(F, P):
    """dbl-2009-l (a = 0); uniform over Z = 0."""
    X, Y, Z = P
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    t = F.sqr(F.add(X, B))
    D = F.double(F.sub(F.sub(t, A), C))
    E = F.add(F.add(A, A), A)
    Fq = F.sqr(E)
    X3 = F.sub(Fq, F.double(D))
    eight_c = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), eight_c)
    Z3 = F.double(F.mul(Y, Z))
    return (X3, Y3, Z3)


def _select(F, cond, P, Q):
    return tuple(F.select(cond, a, b) for a, b in zip(P, Q))


def _repair(F, need, P, out, dbl_fn):
    """dbl(P) into the lanes flagged P == Q (computed only if any is)."""
    if bool(need.any()):
        out = _select(F, need, dbl_fn(P), out)
    return out


def add_formula(F, P, Q, dbl_fn=None):
    """add-2007-bl + exceptional-case selects (both inputs Jacobian)."""
    dbl_fn = dbl_fn or (lambda A: dbl_formula(F, A))
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    I = F.sqr(F.double(H))
    J = F.mul(H, I)
    rr = F.double(F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.double(V))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.double(F.mul(S1, J)))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    need = (F.is_zero(H) & F.is_zero(rr)) & ~(p_inf | q_inf)
    out = _repair(F, need, P, (X3, Y3, Z3), dbl_fn)
    out = _select(F, q_inf, P, out)
    return _select(F, p_inf, Q, out)


def madd_formula(F, P, Q_aff, valid=None, dbl_fn=None):
    """madd-2007-bl: P Jacobian + (x, y, q_inf) affine; lanes with q_inf
    or valid == False keep P."""
    dbl_fn = dbl_fn or (lambda A: dbl_formula(F, A))
    X1, Y1, Z1 = P
    X2, Y2, q_inf = Q_aff
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(X2, Z1Z1)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    HH = F.sqr(H)
    I = F.double(F.double(HH))
    J = F.mul(H, I)
    rr = F.double(F.sub(S2, Y1))
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.double(V))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.double(F.mul(Y1, J)))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    p_inf = F.is_zero(Z1)
    skip = q_inf if valid is None else (q_inf | ~valid)
    need = (F.is_zero(H) & F.is_zero(rr)) & ~(p_inf | skip)
    out = _repair(F, need, P, (X3, Y3, Z3), dbl_fn)
    one = F.one(tuple(p_inf.shape), p_inf.device)
    out = _select(F, p_inf, (X2, Y2, one), out)
    return _select(F, skip, P, out)


def aadd_formula(F, P_aff, Q_aff, dbl_fn=None):
    """mmadd-2007-bl: both operands affine (x, y, inf), six products.
    Infinity in the order of the JAX package's aadd: i2 lifts P, then i1
    lifts Q, both give Z = 0; P == Q lanes take dbl((x1, y1, one))."""
    dbl_fn = dbl_fn or (lambda A: dbl_formula(F, A))
    x1, y1, i1 = P_aff
    x2, y2, i2 = Q_aff
    H = F.sub(x2, x1)
    rr = F.double(F.sub(y2, y1))
    I = F.double(F.double(F.sqr(H)))
    J = F.mul(H, I)
    V = F.mul(x1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.double(V))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.double(F.mul(y1, J)))
    Z3 = F.double(H)
    one = F.one(tuple(i1.shape), i1.device)
    need = (F.is_zero(H) & F.is_zero(rr)) & ~(i1 | i2)
    out = _repair(F, need, (x1, y1, one), (X3, Y3, Z3), dbl_fn)
    out = _select(F, i2, (x1, y1, one), out)
    out = _select(F, i1, (x2, y2, one), out)
    return (out[0], out[1],
            F.select(i1 & i2, torch.zeros_like(out[2]), out[2]))


# ---------------------------------------------------------------- plain

def dbl_plain(fk, P, reps: int = 1):
    F = fk.as_plain()
    for _ in range(reps):
        P = dbl_formula(F, P)
    return P


def add_plain(fk, P, Q):
    return add_formula(fk.as_plain(), P, Q)


def madd_plain(fk, P, Q_aff, valid=None):
    return madd_formula(fk.as_plain(), P, Q_aff, valid)


def aadd_plain(fk, P_aff, Q_aff):
    return aadd_formula(fk.as_plain(), P_aff, Q_aff)


# ------------------------------------------------------------- launchers

def _flatten(fk, arrs):
    """Field tensors -> contiguous (FW, L) int32, with the batch shape."""
    lead = 1 + (ext_of(fk) == 2)
    arrs = torch.broadcast_tensors(*arrs)
    batch = tuple(arrs[0].shape[lead:])
    FW = ext_of(fk) * fk.N
    L = 1
    for s in batch:
        L *= s
    out = []
    for a in arrs:
        if a.dtype != torch.int32:
            raise TypeError("EC kernels take int32 limb tensors")
        out.append(a.reshape(FW, L).contiguous())
    return out, batch, L


def _mask(m, batch, L):
    m = torch.as_tensor(m).expand(batch).reshape(L)
    return m.to(torch.bool).contiguous()


def _unflatten(fk, outs, batch):
    lead = (2, fk.N) if ext_of(fk) == 2 else (fk.N,)
    return tuple(o.reshape(lead + batch) for o in outs)


def _call(fn_name, fk, ins, L, extra=(), kernel=""):
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    f = getattr(cuda_lib.lib("ec"), fn_name)
    ptrs = [t.data_ptr() if t is not None else None for t in ins]
    args = ([fk.nw, ext_of(fk)] + ptrs + [o.data_ptr() for o in outs] + [L]
            + list(extra) + [ctypes.addressof(fk.mod),
                             cuda_lib.stream_ptr(outs[0])])
    cuda_lib.check(f(*args), kernel)
    LAUNCHES[counter_key(kernel, fk)] += 1
    return outs


def dbl(fk, P, reps: int = 1):
    """reps successive doublings of Jacobian P (ONE launch on the card)."""
    if not P[0].is_cuda:
        return dbl_plain(fk, P, reps)
    flat, batch, L = _flatten(fk, P)
    outs = _call("lsn_ec_dbl", fk, flat, L, (reps,), "dbl")
    return _unflatten(fk, outs, batch)


def add(fk, P, Q):
    if not P[0].is_cuda:
        return add_plain(fk, P, Q)
    flat, batch, L = _flatten(fk, (*P, *Q))
    outs = _call("lsn_ec_add", fk, flat, L, (), "add")
    return _unflatten(fk, outs, batch)


def madd(fk, P, Q_aff, valid=None):
    if not P[0].is_cuda:
        return madd_plain(fk, P, Q_aff, valid)
    X2, Y2, q_inf = Q_aff
    flat, batch, L = _flatten(fk, (*P, X2, Y2))
    qi = _mask(q_inf, batch, L)
    va = _mask(valid, batch, L) if valid is not None else None
    outs = _call("lsn_ec_madd", fk, flat + [qi, va], L, (), "madd")
    return _unflatten(fk, outs, batch)


def aadd(fk, P_aff, Q_aff):
    """Affine (x, y, inf) + affine (x, y, inf) -> Jacobian, one launch."""
    x1, y1, i1 = P_aff
    x2, y2, i2 = Q_aff
    if not x1.is_cuda:
        return aadd_plain(fk, P_aff, Q_aff)
    flat, batch, L = _flatten(fk, (x1, y1, x2, y2))
    ins = [flat[0], flat[1], _mask(i1, batch, L), flat[2], flat[3],
           _mask(i2, batch, L)]
    outs = _call("lsn_ec_aadd", fk, ins, L, (), "aadd")
    return _unflatten(fk, outs, batch)
