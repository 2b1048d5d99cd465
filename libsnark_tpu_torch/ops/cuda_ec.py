"""Elementwise Jacobian group ops: the CUDA kernels and their plain versions.

Replace the Pallas TPU kernels ``libsnark_tpu/ops/pallas_ec.py:_build_dbl``
(``dbl``), ``_build_add`` (``add``), ``_build_madd`` (``madd``) and
``_build_aadd`` (``aadd``), for G1 (coordinates over Fp, ext = 1) and G2
(over Fp2, ext = 2), a = 0 curves, at every built group width. Curves with
an a-coefficient (MNT4, MNT6, edwards) take the formulas below over the
product kernel, with G2 over Fp2 or Fp3.
``madd_windows`` runs the JAX package's fixed-base scan (``batch_exp``, one
Pallas madd a window under a ``lax.scan``) in one launch: each thread keeps
its lane's accumulator in registers across every window, takes its digits
from the scalar limbs itself and reads one packed table row a window.
``aadd_rows`` runs level 0 of one chunk of the dense MSM (the JAX
package's ``window_sums_dense``: a row gather, a transpose and one Pallas
aadd) in one launch: each thread finds its two rows through the bucket runs
and reads them from the packed row table itself, so no gathered or
limb-major copy of the rows is made.

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
from .cuda_fp import small_lanes
from .int_lanes import on_lanes
from .limbs import LIMB_BITS, words_to_limbs

def counter_keys(kernels):
    """Launch-counter keys: one per kernel, coordinate field (fp: G1, fp2:
    G2) and field width (N 16-bit limbs)."""
    return [f"{k}_{f}_n{2 * nw}" for k in kernels for f in ("fp", "fp2")
            for nw in (cuda_lib.GROUP_WIDTHS if f == "fp" else
                       cuda_lib.FP2_WIDTHS)]


LAUNCHES = dict.fromkeys(counter_keys(("dbl", "add", "madd", "aadd",
                                       "madd_win", "aadd_rows")), 0)
# the work of those launches: lanes (dbl: lanes x doublings; madd_win: the
# madds after each lane's first window, lanes x (windows - 1); aadd_rows:
# output lanes, two rows each)
WORK = dict.fromkeys(LAUNCHES, 0)
# aadd_rows: the lanes whose two depths both lie within their bucket's
# count, the ones that run the formula's products (a device scalar, so
# that counting never waits for the card)
LIVE_PAIRS = dict.fromkeys(counter_keys(("aadd_rows",)), 0)


def ext_of(fk) -> int:
    """Coordinate field degree: 3 for an Fp3Kernel, 2 for an Fp2Kernel, 1
    for an FpKernel."""
    return getattr(fk, "ext_degree", 1)


def lead_of(fk) -> tuple:
    """The leading (coefficient, limb) axes of a field element of fk."""
    ext = ext_of(fk)
    return (ext, fk.N) if ext > 1 else (fk.N,)


def width_args(fk):
    """The (nw, ext) arguments of a group kernel's C entry for field kernel
    fk; raises where csrc builds none (Fp at ``GROUP_WIDTHS``, Fp2 at
    ``FP2_WIDTHS``, no Fp3: only curves with an a-coefficient have a G2
    over Fp3, and they run no group kernel), as the C entries refuse it."""
    nw, ext = fk.nw, ext_of(fk)
    built = {1: cuda_lib.GROUP_WIDTHS, 2: cuda_lib.FP2_WIDTHS}.get(ext, ())
    if nw not in built or 2 * nw != fk.N:
        raise ValueError(f"no group kernels built over a field of degree "
                         f"{ext} at {nw} 32-bit words ({fk.N} limbs; Fp at "
                         f"{cuda_lib.GROUP_WIDTHS}, Fp2 at "
                         f"{cuda_lib.FP2_WIDTHS})")
    return nw, ext


def counter_key(kernel: str, fk) -> str:
    ext = ext_of(fk)
    return f"{kernel}_{f'fp{ext}' if ext > 1 else 'fp'}_n{fk.N}"


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


def dbl_generic_formula(F, P, mul_by_a):
    """dbl-2007-bl with M = 3*XX + a*ZZ^2 (generic a; mul_by_a multiplies
    by the curve's a), the independent products stacked into one call
    each, as in the JAX package."""
    X, Y, Z = P
    s1 = F.stack([X, Y, Z])
    XX, YY, ZZ = F.unstack(F.mul(s1, s1))
    s2 = F.stack([YY, F.add(X, YY), ZZ, F.add(Y, Z)])
    YYYY, t, ZZ2, w = F.unstack(F.mul(s2, s2))
    S = F.double(F.sub(F.sub(t, XX), YYYY))
    M = F.add(F.add(F.add(XX, XX), XX), mul_by_a(ZZ2))
    X3 = F.sub(F.sqr(M), F.double(S))
    Y3 = F.sub(F.mul(M, F.sub(S, X3)),
               F.double(F.double(F.double(YYYY))))
    Z3 = F.sub(F.sub(w, YY), ZZ)
    return (X3, Y3, Z3)


def _select(F, cond, P, Q):
    return tuple(F.select(cond, a, b) for a, b in zip(P, Q))


def _repair(F, need, P, out, dbl_fn):
    """dbl(P) into the lanes flagged P == Q (computed only if any is)."""
    if bool(need.any()):
        out = _select(F, need, dbl_fn(P), out)
    return out


def add_formula(F, P, Q, dbl_fn=None):
    """add-2007-bl + exceptional-case selects (both inputs Jacobian); the
    independent products stacked into one call each, in the JAX package's
    schedule."""
    dbl_fn = dbl_fn or (lambda A: dbl_formula(F, A))
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = F.unstack(F.mul(F.stack([Z1, Z2, Y1, Y2]),
                                             F.stack([Z1, Z2, Z2, Z1])))
    U1, U2, S1, S2 = F.unstack(F.mul(F.stack([X1, X2, Y1Z2, Y2Z1]),
                                     F.stack([Z2Z2, Z1Z1, Z2Z2, Z1Z1])))
    H, dS = F.unstack(F.sub(F.stack([U2, S2]), F.stack([U1, S1])))
    H2, rr, Zs = F.unstack(F.add(F.stack([H, dS, Z1]),
                                 F.stack([H, dS, Z2])))
    s3 = F.stack([H2, rr, Zs])
    I, rr2, w = F.unstack(F.mul(s3, s3))
    J, V = F.unstack(F.mul(F.stack([H, U1]), F.stack([I, I])))
    X3 = F.sub(F.sub(rr2, J), F.double(V))
    m1, m2, Z3 = F.unstack(F.mul(
        F.stack([rr, S1, F.sub(F.sub(w, Z1Z1), Z2Z2)]),
        F.stack([F.sub(V, X3), J, H])))
    Y3 = F.sub(m1, F.double(m2))
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    need = (F.is_zero(H) & F.is_zero(rr)) & ~(p_inf | q_inf)
    out = _repair(F, need, P, (X3, Y3, Z3), dbl_fn)
    out = _select(F, q_inf, P, out)
    return _select(F, p_inf, Q, out)


def madd_formula(F, P, Q_aff, valid=None, dbl_fn=None):
    """madd-2007-bl: P Jacobian + (x, y, q_inf) affine; lanes with q_inf
    or valid == False keep P. Products stacked as in add_formula."""
    dbl_fn = dbl_fn or (lambda A: dbl_formula(F, A))
    X1, Y1, Z1 = P
    X2, Y2, q_inf = Q_aff
    Z1Z1, Y2Z1 = F.unstack(F.mul(F.stack([Z1, Y2]), F.stack([Z1, Z1])))
    U2, S2 = F.unstack(F.mul(F.stack([X2, Y2Z1]), F.stack([Z1Z1, Z1Z1])))
    H, dS = F.unstack(F.sub(F.stack([U2, S2]), F.stack([X1, Y1])))
    rr = F.double(dS)
    s3 = F.stack([H, rr])
    HH, rr2 = F.unstack(F.mul(s3, s3))
    I = F.double(F.double(HH))
    ZH = F.add(Z1, H)
    J, V, w = F.unstack(F.mul(F.stack([H, X1, ZH]), F.stack([I, I, ZH])))
    X3 = F.sub(F.sub(rr2, J), F.double(V))
    m1, m2 = F.unstack(F.mul(F.stack([rr, Y1]), F.stack([F.sub(V, X3), J])))
    Y3 = F.sub(m1, F.double(m2))
    Z3 = F.sub(F.sub(w, Z1Z1), HH)
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
    H, dy = F.unstack(F.sub(F.stack([x2, y2]), F.stack([x1, y1])))
    rr = F.double(dy)
    s1 = F.stack([H, rr])
    HH, rr2 = F.unstack(F.mul(s1, s1))
    I = F.double(F.double(HH))
    J, V = F.unstack(F.mul(F.stack([H, x1]), F.stack([I, I])))
    X3 = F.sub(F.sub(rr2, J), F.double(V))
    m1, m2 = F.unstack(F.mul(F.stack([rr, y1]), F.stack([F.sub(V, X3), J])))
    Y3 = F.sub(m1, F.double(m2))
    Z3 = F.double(H)
    one = F.one(tuple(i1.shape), i1.device)
    need = (F.is_zero(H) & F.is_zero(rr)) & ~(i1 | i2)
    out = _repair(F, need, (x1, y1, one), (X3, Y3, Z3), dbl_fn)
    out = _select(F, i2, (x1, y1, one), out)
    out = _select(F, i1, (x2, y2, one), out)
    return (out[0], out[1],
            F.select(i1 & i2, torch.zeros_like(out[2]), out[2]))


# ---------------------------------------------------------------- plain

# On the CPU, up to int_lanes.INT_LANES lanes, dbl / add / madd run their
# formulas lane by lane on Python integers (int_lanes.on_lanes: the same
# limbs); else, and for limbs outside [0, 2^16), the torch forms.

def _dbl_reps(F, P, reps: int):
    for _ in range(reps):
        P = dbl_formula(F, P)
    return P


def dbl_plain(fk, P, reps: int = 1):
    if small_lanes(P[0]):
        out = on_lanes(fk, lambda F, v, m: _dbl_reps(F, tuple(v), reps),
                       list(P))
        if out is not None:
            return out
    return _dbl_reps(fk.as_plain(), P, reps)


def add_plain(fk, P, Q):
    if small_lanes(P[0], Q[0]):
        out = on_lanes(fk, lambda F, v, m: add_formula(
            F, tuple(v[:3]), tuple(v[3:])), list(P) + list(Q))
        if out is not None:
            return out
    return add_formula(fk.as_plain(), P, Q)


def madd_plain(fk, P, Q_aff, valid=None):
    if small_lanes(P[0], Q_aff[0]):
        out = on_lanes(fk, lambda F, v, m: madd_formula(
            F, tuple(v[:3]), (v[3], v[4], m[0]), m[1]),
            list(P) + list(Q_aff[:2]), (Q_aff[2], valid))
        if out is not None:
            return out
    return madd_formula(fk.as_plain(), P, Q_aff, valid)


def aadd_plain(fk, P_aff, Q_aff):
    return aadd_formula(fk.as_plain(), P_aff, Q_aff)


def aadd_rows_composed(fk, aadd_fn, rows, gidx, starts, counts, m: int,
                       base: int, half: int, w_lo: int, Wn: int, nb: int):
    """Level 0 of one dense-MSM chunk as torch passes around one
    ``aadd_fn``: the runs' rows at depths base .. base + 2 half - 1 gathered
    into a (2 half, Wn, nb) layout, split into 16-bit limbs, the infinity
    mask (y == 0 or depth >= count), then aadd_fn(lo, hi) on the two
    halves. The form ``aadd_rows`` replaced on the card."""
    FW = ext_of(fk) * fk.N
    lead = lead_of(fk)
    R = 2 * half
    dev = rows.device
    st = starts[w_lo:w_lo + Wn, :nb].to(torch.int64)
    ct = counts[w_lo:w_lo + Wn, :nb].to(torch.int64)
    woff = (torch.arange(w_lo, w_lo + Wn, dtype=torch.int64, device=dev)
            * m)[None, :, None]
    depth = base + torch.arange(R, dtype=torch.int64, device=dev)[:, None, None]
    pos = torch.clamp(st[None] + depth, 0, m - 1)            # (R, Wn, nb)
    live = (depth < ct[None]).reshape(R, Wn * nb)
    rg = gidx[(woff + pos).reshape(-1)].to(torch.int64)
    gt = words_to_limbs(rows[rg].T)                           # (2FW, K)
    qx = gt[:FW].reshape(lead + (R, Wn * nb))
    qy = gt[FW:].reshape(lead + (R, Wn * nb))
    qinf = (gt[FW:] == 0).all(dim=0).reshape(R, Wn * nb) | ~live
    lo = (qx.narrow(-2, 0, half), qy.narrow(-2, 0, half), qinf[:half])
    hi = (qx.narrow(-2, half, half), qy.narrow(-2, half, half), qinf[half:])
    return aadd_fn(lo, hi)


def aadd_rows_plain(fk, rows, gidx, starts, counts, m: int, base: int,
                    half: int, w_lo: int, Wn: int, nb: int):
    """``aadd_rows`` over plain products: the gathered form with
    ``aadd_plain``."""
    return aadd_rows_composed(fk, lambda P, Q: aadd_plain(fk, P, Q), rows,
                              gidx, starts, counts, m, base, half, w_lo, Wn,
                              nb)


def window_digit(sc, c: int, w: int):
    """The unsigned c-bit digit of window w of (NL, m) int64 plain 16-bit
    scalar limbs, the JAX package's batch_exp extraction (a digit may span
    two limbs; bits past the last limb are zero). None when the window
    starts past the last limb: its digit is 0 in every lane."""
    li, sh = divmod(c * w, LIMB_BITS)
    if li >= sc.shape[0]:
        return None
    raw = sc[li] >> sh
    if sh + c > LIMB_BITS and li + 1 < sc.shape[0]:
        raw = raw | (sc[li + 1] << (LIMB_BITS - sh))
    return raw & ((1 << c) - 1)


def table_from_rows(fk, rows, c: int):
    """(W 2^c, FW) packed rows -> the affine table (x, y, inf) with batch
    (W, 2^c); a row with y == 0 is infinity."""
    FW = ext_of(fk) * fk.N
    W = rows.shape[0] >> c
    lead = lead_of(fk)
    limbs = words_to_limbs(rows.T)
    y = limbs[FW:]
    return (limbs[:FW].reshape(lead + (W, 1 << c)),
            y.reshape(lead + (W, 1 << c)),
            (y == 0).all(dim=0).reshape(W, 1 << c))


def windows_scan(fk, table_aff, scalars, c: int, madd_fn):
    """acc <- madd_fn(acc, T[w, digit_w]) for w = 0 .. W - 1 from infinity
    (1, 1, 0): the JAX package's batch_exp scan, one madd a window."""
    tx, ty, tinf = table_aff
    m = scalars.shape[-1]
    dev = scalars.device
    sc = scalars.to(torch.int64)
    one = fk.one((m,), dev)
    acc = (one, one.clone(), fk.zeros((m,), dev))
    for w in range(tx.shape[-2]):
        dig = window_digit(sc, c, w)
        if dig is None:
            break
        acc = madd_fn(acc, (tx[..., w, :][..., dig], ty[..., w, :][..., dig],
                            tinf[w][dig]))
    return acc


def madd_windows_plain(fk, rows, scalars, c: int):
    """The windowed madd over plain products: the scan of ``windows_scan``
    with ``madd_plain`` on the table the packed rows hold."""
    return windows_scan(fk, table_from_rows(fk, rows, c), scalars, c,
                        lambda P, Q: madd_plain(fk, P, Q))


# ------------------------------------------------------------- launchers

def _flatten(fk, arrs):
    """Field tensors -> contiguous (FW, L) int32, with the batch shape."""
    lead = 1 + (ext_of(fk) > 1)
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
    lead = lead_of(fk)
    return tuple(o.reshape(lead + batch) for o in outs)


def _call(fn_name, fk, ins, L, extra=(), kernel="", work=None):
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    f = getattr(cuda_lib.lib("ec"), fn_name)
    ptrs = [t.data_ptr() if t is not None else None for t in ins]
    args = ([*width_args(fk)] + ptrs + [o.data_ptr() for o in outs] + [L]
            + list(extra) + [ctypes.addressof(fk.mod),
                             cuda_lib.stream_ptr(outs[0])])
    cuda_lib.check(f(*args), kernel)
    LAUNCHES[counter_key(kernel, fk)] += 1
    WORK[counter_key(kernel, fk)] += L if work is None else work
    return outs


def dbl(fk, P, reps: int = 1):
    """reps successive doublings of Jacobian P (ONE launch on the card)."""
    if not P[0].is_cuda:
        return dbl_plain(fk, P, reps)
    flat, batch, L = _flatten(fk, P)
    outs = _call("lsn_ec_dbl", fk, flat, L, (reps,), "dbl", L * reps)
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


def madd_windows(fk, rows, scalars, c: int):
    """Fixed-base exponentiation in ONE launch on the card: lane i gets
    sum_w T[w, digit_w(scalars[:, i])], w = 0 .. W - 1, as Jacobian
    (X, Y, Z) with batch (m,): the limbs of the per-window madd loop.

    rows: the (W 2^c, FW) int32 packed row table (``MSMKernel.row_table``
    of the affine window table, row w 2^c + j = j 2^(c w) base, all zero
    for infinity; row 0 of each window is infinity). scalars: (NL, m)
    int32 plain 16-bit limbs. c: window bits, 1 to 16."""
    if not 1 <= c <= 16:
        raise ValueError(f"madd_windows takes 1 to 16 window bits, not {c}")
    FW = ext_of(fk) * fk.N
    if (rows.dim() != 2 or rows.shape[1] != FW or rows.shape[0] % (1 << c)
            or rows.dtype != torch.int32 or scalars.dtype != torch.int32
            or scalars.dim() != 2 or scalars.shape[0] == 0):
        raise ValueError(f"madd_windows takes a (W 2^c, {FW}) int32 row "
                         "table and (NL, m) int32 scalar limbs")
    if not rows.is_cuda:
        return madd_windows_plain(fk, rows, scalars, c)
    if scalars.device != rows.device:
        raise ValueError("madd_windows: rows and scalars on one device")
    rows = rows.contiguous()
    scalars = scalars.contiguous()
    if rows.data_ptr() % 16:
        raise ValueError("madd_windows: the row table must be 16-byte aligned")
    nl, m = scalars.shape
    W = rows.shape[0] >> c
    lead = lead_of(fk)
    outs = [torch.empty(lead + (m,), dtype=torch.int32, device=rows.device)
            for _ in range(3)]
    if m == 0:
        return tuple(outs)
    code = cuda_lib.lib("ec").lsn_ec_madd_windows(
        *width_args(fk), rows.data_ptr(), scalars.data_ptr(), nl, c, W,
        *[o.data_ptr() for o in outs], m, ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(rows))
    cuda_lib.check(code, "madd_win")
    key = counter_key("madd_win", fk)
    LAUNCHES[key] += 1
    WORK[key] += m * max(0, W - 1)
    return tuple(outs)


def aadd_rows(fk, rows, gidx, starts, counts, m: int, base: int, half: int,
              w_lo: int, Wn: int, nb: int):
    """Level 0 of one dense-MSM chunk in ONE launch on the card.

    rows:   (2m, FW) int32 signed packed row table (``MSMKernel.row_table``
            with signed=True: [x | y] rows, then [x | -y]; all zero for
            infinity), 16-byte aligned
    gidx:   (W m,) signed row indices idx + sign m, sorted per window
    starts, counts: (W, ncols) bucket runs in gidx (per window)
    m:      points; the chunk: depths base .. base + 2 half - 1 of the
            buckets 0 .. nb - 1 of windows w_lo .. w_lo + Wn - 1

    Output lane (r, w, b), r < half, is the affine sum of the rows at
    depths base + r and base + r + half of bucket (w_lo + w, b), as
    Jacobian (X, Y, Z) with batch (half, Wn nb): the limbs of
    ``aadd_rows_composed`` (the row gather, the limb split, the infinity
    mask and one ``aadd`` launch). A row is infinity where its y is zero or
    its depth is at least the bucket's count."""
    FW = ext_of(fk) * fk.N
    if (rows.dim() != 2 or rows.shape != (2 * m, FW)
            or rows.dtype != torch.int32):
        raise ValueError(f"aadd_rows takes the (2m, {FW}) int32 signed row "
                         "table")
    if (gidx.dim() != 1 or m < 1 or gidx.numel() % m or starts.dim() != 2
            or starts.shape != counts.shape
            or starts.shape[0] != gidx.numel() // m
            or any(t.is_floating_point() for t in (gidx, starts, counts))):
        raise ValueError("aadd_rows takes (W m,) row indices and (W, ncols) "
                         "integer bucket starts and counts")
    if not (half >= 1 and base >= 0 and Wn >= 1 and w_lo >= 0
            and w_lo + Wn <= starts.shape[0] and 1 <= nb <= starts.shape[1]):
        raise ValueError(f"aadd_rows: chunk base={base}, half={half}, "
                         f"windows [{w_lo}, {w_lo + Wn}), {nb} buckets is "
                         f"outside the ({starts.shape[0]}, {starts.shape[1]}) "
                         "bucket runs")
    L = half * Wn * nb
    if L >= 1 << 31 or base + 2 * half >= 1 << 31:
        raise ValueError("aadd_rows: a chunk takes fewer than 2^31 lanes")
    if not rows.is_cuda:
        return aadd_rows_plain(fk, rows, gidx, starts, counts, m, base, half,
                               w_lo, Wn, nb)
    if any(t.device != rows.device for t in (gidx, starts, counts)):
        raise ValueError("aadd_rows: rows, gidx, starts and counts on one "
                         "device")
    rows = rows.contiguous()
    if rows.data_ptr() % 16:
        raise ValueError("aadd_rows: the row table must be 16-byte aligned")
    gidx, starts, counts = (t.to(torch.int32).contiguous()
                            for t in (gidx, starts, counts))
    lead = lead_of(fk)
    outs = [torch.empty((FW, L), dtype=torch.int32, device=rows.device)
            for _ in range(3)]
    code = cuda_lib.lib("ec").lsn_ec_aadd_rows(
        *width_args(fk), rows.data_ptr(), gidx.data_ptr(),
        starts.data_ptr(), counts.data_ptr(), starts.shape[1], m, base, half,
        w_lo, Wn, nb, *[o.data_ptr() for o in outs], L,
        ctypes.addressof(fk.mod), cuda_lib.stream_ptr(rows))
    cuda_lib.check(code, "aadd_rows")
    key = counter_key("aadd_rows", fk)
    LAUNCHES[key] += 1
    WORK[key] += L
    LIVE_PAIRS[key] += (counts[w_lo:w_lo + Wn, :nb] - (base + half)).clamp(
        0, half).sum(dtype=torch.int64)
    return tuple(o.reshape(lead + (half, Wn * nb)) for o in outs)
