"""Multi-scalar multiplication (the port of libsnark_tpu/ops/msm.py).

Variable-base MSM, signed-digit Pippenger:

  1. signed c-bit digits from plain 16-bit-limb scalars (vectorized);
  2. one packed sort key per (window, point): |digit|, sign, point index --
     the sorted key yields each position's signed row index idx + sign*m
     and ``searchsorted`` gives every bucket's run;
  3. bucket accumulation, by the kernel's ``strategy``:
     ``"segments"`` (the default): ``bucket_reduce`` (ops/cuda_bucket.py),
     one kernel launch reduces all bucket runs, cut into segments of
     bounded length (one thread each, longest segments first, gathering its
     own rows from the packed row table); a pairwise add tree joins the
     segments of a bucket;
     ``"dense"``: the runs are gathered into a dense (depth, window,
     bucket) layout, level 0 is one ``aadd`` launch on pairs of affine
     rows, the levels above are ``add`` launches (a log-depth tree), and
     buckets deeper than the chunk depth take further chunks;
  4. sum_j j*S_j per window = sum_{j>=1} T_j, with T the suffix sums (one
     Hillis-Steele point scan + a log-depth lane reduction, add kernel);
  5. ``horner_combine`` joins the windows in one launch.

``"segments"`` ports the RESULT of the JAX ``window_sums_fused``, not its
TPU shape: the R_SUB roll tree, 128-bucket tiles, VMEM caps, two-class
depth, virtual sub-bucket splits and the 2^16 SEGMENT scan are artifacts of
Mosaic and the compile service, and the GPU kernel needs none of them.
``"dense"`` ports ``window_sums_dense``, the configuration the JAX package
runs with its fused kernel switched off and the only one of its curves
with an a-coefficient. Both give the same affine sums; the Jacobian
window sums differ.

Fixed-base batch exp (libff batch_exp / get_window_table): device-built
window tables via a point prefix scan, then one ``madd_windows`` launch
that runs every window of every lane (ops/cuda_ec.py).

Scalars are plain (non-Montgomery) (NL, m) int32 16-bit limb tensors.
"""
from __future__ import annotations

import math

import torch

from .cuda_bucket import bucket_reduce, horner_combine
from .cuda_ec import ext_of, madd_windows, windows_scan
from .limbs import LIMB_BITS, ints_to_limbs, limbs_to_words, words_to_limbs


def default_window_bits(m: int) -> int:
    """Window size for an m-point MSM on the card: about log2(m) - 5, so
    that buckets stay ~32-64 points deep and one thread per bucket fills
    the card (W*(B+1) ~ 3*10^5 threads at 2^20), while the suffix scan
    over B+1 buckets stays a fraction of the bucket work. The window
    choice changes the Jacobian intermediates, never the affine result."""
    return max(4, min(16, int(math.log2(max(m, 2))) - 5))


STRATEGIES = ("segments", "dense")

# Dense strategy: bytes one chunk may hold on the card. A chunk of K lanes
# holds the gathered rows, their limb-major copy, the operand copies of the
# level-0 launch and its output: about 32 bytes per lane and coordinate
# limb. The JAX package caps a chunk at 2^22 lanes for the TPU's memory;
# 8 GiB of an 80 GB card allow 16M lanes for a 16-limb G1 and 2.8M for a
# 24-limb G2. The cap changes the chunk count, never a result.
DENSE_CHUNK_BYTES = 8 << 30


def _tree_map(f, *pts):
    return tuple(f(*xs) for xs in zip(*pts))


class MSMKernel:
    """MSM over one curve group.

    ck: CurveKernel (G1 or G2); scalar_bits: bit length of r; strategy:
    the bucket accumulation of ``window_sums`` (see the module doc).
    """

    def __init__(self, ck, scalar_bits: int, strategy: str = "segments"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown MSM strategy {strategy!r}; "
                             f"available: {STRATEGIES}")
        self.ck = ck
        self.fk = ck.fk
        self.scalar_bits = scalar_bits
        self.strategy = strategy

    def __hash__(self):
        return hash((self.ck, self.scalar_bits, self.strategy))

    def __eq__(self, o):
        return (isinstance(o, MSMKernel) and o.ck == self.ck
                and o.scalar_bits == self.scalar_bits
                and o.strategy == self.strategy)

    # ------------------------------------------------------------------ digits
    def num_windows(self, c: int) -> int:
        return -(-self.scalar_bits // c) + 1

    def signed_digits(self, scalars, c: int):
        """(NL, m) scalar limbs -> (W, m) |digit| int64 and (W, m) sign bool.

        Signed c-bit windows: digit in [-(2^(c-1)-1), 2^(c-1)], so buckets
        1..2^(c-1). LSB window first; the top window takes the last carry.
        """
        nl, m = scalars.shape
        W = self.num_windows(c)
        half = 1 << (c - 1)
        full = 1 << c
        sc = scalars.to(torch.int64)
        abss, signs = [], []
        carry = torch.zeros((m,), dtype=torch.int64, device=sc.device)
        for w in range(W):
            o = c * w
            li, sh = o // LIMB_BITS, o % LIMB_BITS
            if li < nl:
                raw = sc[li] >> sh
                if sh + c > LIMB_BITS and li + 1 < nl:
                    raw = raw | (sc[li + 1] << (LIMB_BITS - sh))
            else:
                raw = torch.zeros_like(carry)
            raw = (raw & (full - 1)) + carry
            neg = raw > half
            abss.append(torch.where(neg, full - raw, raw))
            signs.append(neg)
            carry = neg.to(torch.int64)
        return torch.stack(abss), torch.stack(signs)

    def _sort_signed_bounds(self, digits, signs, m: int, B: int):
        """Per-window sort with the digit SIGN packed into the key:
        key = (|digit| << (idx_bits+1)) | (sign << idx_bits) | idx.

        Keys are unique, so the order is the JAX package's. Returns
        (gidx, starts, counts): signed row indices idx + sign*m in sorted
        order (W, m), run starts (W, B+1) and run lengths (W, B+1) with
        bucket 0 zeroed (zero digits are never accumulated)."""
        idx_bits = max(1, (m - 1).bit_length())
        W = digits.shape[0]
        iota = torch.arange(m, dtype=torch.int64, device=digits.device)
        key = ((digits << (idx_bits + 1))
               | (signs.to(torch.int64) << idx_bits) | iota)
        skey, _ = torch.sort(key, dim=-1)
        low = skey & ((1 << (idx_bits + 1)) - 1)
        gidx = (low & ((1 << idx_bits) - 1)) + (low >> idx_bits) * m
        dig_s = (skey >> (idx_bits + 1)).contiguous()
        targets = torch.arange(B + 2, dtype=torch.int64,
                               device=digits.device).expand(W, B + 2)
        bounds = torch.searchsorted(dig_s, targets.contiguous())
        starts = bounds[:, :B + 1]
        counts = bounds[:, 1:] - bounds[:, :B + 1]
        counts[:, 0] = 0
        return gidx, starts, counts

    def row_table(self, points_aff, signed: bool = False):
        """Affine (x, y, inf) -> (m, FW) int32 packed rows [x | y]: each
        coordinate as its FW / 2 32-bit words (``limbs_to_words``, the
        kernels' register layout; Fp2 rows are [x0 x1 | y0 y1]), half the
        bytes of its 16-bit limbs. Infinity rows are all zero (y == 0 is
        never a valid affine point here). signed: m further rows [x | -y],
        so that a signed row index idx + sign*m gathers the point a
        negative digit adds."""
        x, y, inf = points_aff
        FW = ext_of(self.fk) * self.fk.N
        m = x.shape[-1]
        ys = [y, self.fk.neg(y)] if signed else [y]
        rows = torch.cat([limbs_to_words(torch.cat(
            [x.reshape(FW, m), v.reshape(FW, m)], dim=0)).T for v in ys],
            dim=0)
        dead = inf.reshape(m, 1).repeat(len(ys), 1)
        return torch.where(dead, torch.zeros_like(rows), rows).contiguous()

    # ------------------------------------------------------- point scan helpers
    def _shifted(self, pts, width: int, shift: int):
        """Lane j <- lane j + shift; lanes past the end are infinity."""
        def sh(a):
            pad = torch.zeros(a.shape[:-1] + (shift,), dtype=a.dtype,
                              device=a.device)
            return torch.cat([a[..., shift:], pad], dim=-1)
        return tuple(sh(a) for a in pts)

    def _suffix_scan_add(self, pts, width: int):
        """T_j = sum_{b >= j} P_b via Hillis-Steele: log2(width) rounds of
        one point add each."""
        steps = max(1, (width - 1).bit_length())
        for k in range(steps):
            if (1 << k) >= width:
                break
            pts = self.ck.add(pts, self._shifted(pts, width, 1 << k))
        return pts

    def _tree_reduce_points(self, P, axis: int = -1):
        """Reduce a Jacobian point array over one batch axis (the last by
        default) with a halving add tree (odd widths padded with
        infinity)."""
        ck = self.ck
        width = P[0].shape[axis]
        while width > 1:
            if width % 2:
                P = _tree_map(lambda a: torch.cat(
                    [a, torch.zeros_like(a.narrow(axis, 0, 1))], dim=axis), P)
                width += 1
            h = width // 2
            P = ck.add(_tree_map(lambda a: a.narrow(axis, 0, h), P),
                       _tree_map(lambda a: a.narrow(axis, h, h), P))
            width = h
        return P

    # ------------------------------------------------------------- core MSM
    def msm(self, points_aff, scalars, c: int = None):
        """sum_i scalars[i] * P_i.

        points_aff: (x, y, inf_mask) affine tensors, batch m on the last axis.
        scalars: (NL, m) int32 plain-integer limbs.
        Returns a Jacobian point with batch shape (1,).
        """
        c = c or default_window_bits(scalars.shape[-1])
        S = self.window_sums(points_aff, scalars, c)
        return self.combine_windows(S, c)

    def window_sums(self, points_aff, scalars, c: int):
        """Per-window bucket-aggregated sums S_w (leading axis W), by the
        kernel's strategy."""
        if self.strategy == "dense":
            return self.window_sums_dense(points_aff, scalars, c)
        return self.window_sums_segments(points_aff, scalars, c)

    def bucket_segments(self, scalars, c: int):
        """Sort front end + bucket runs cut into bounded segments.

        Every (window, bucket) run longer than ``seg_len`` rows is cut into
        segments of at most ``seg_len`` rows, each reduced by its own
        thread of ``bucket_reduce``: a run's length follows the scalars
        (a partial top window puts m / 2^eff points in each of its few
        buckets; equal scalars put all m in one), and one thread per whole
        run would serialise it. Segments stay in (bucket, rank) order.

        ``seg_order`` lists the segments longest first (ties in segment
        order), the order in which ``bucket_reduce`` hands them to threads.

        Returns dict(gidx (W*m,) int32, seg_start (S,) int64, seg_count
        (S,) int32, seg_order (S,) int64, seg_bucket (S,) int64,
        num_buckets W*(B+1), W)."""
        m = scalars.shape[-1]
        B = 1 << (c - 1)
        digits, signs = self.signed_digits(scalars, c)         # (W, m)
        W = digits.shape[0]
        gidx, starts, counts = self._sort_signed_bounds(digits, signs, m, B)
        dev = starts.device
        st = (starts + (torch.arange(W, dtype=torch.int64, device=dev)
                        * m)[:, None]).reshape(-1)
        ct = counts.reshape(-1)
        seg_len = max(16, 2 * (-(-m // B)))
        nseg = (ct + seg_len - 1) // seg_len
        bucket = torch.repeat_interleave(
            torch.arange(ct.shape[0], dtype=torch.int64, device=dev), nseg)
        first = torch.cumsum(nseg, 0) - nseg
        rank = (torch.arange(bucket.shape[0], dtype=torch.int64, device=dev)
                - first[bucket])
        seg_count = torch.clamp(ct[bucket] - rank * seg_len,
                                max=seg_len).to(torch.int32)
        return dict(gidx=gidx.reshape(-1).to(torch.int32),
                    seg_start=st[bucket] + rank * seg_len,
                    seg_count=seg_count,
                    seg_order=torch.argsort(seg_count, descending=True,
                                            stable=True),
                    seg_bucket=bucket, num_buckets=ct.shape[0], W=W)

    def _combine_segments(self, P, bucket, num_buckets: int):
        """Sum segment points of the same bucket (segments in (bucket,
        rank) order) with a pairwise tree, one add launch per level; then
        scatter to (lead, num_buckets), infinity for empty buckets."""
        ck = self.ck
        dev = bucket.device
        rank = torch.arange(bucket.shape[0], dtype=torch.int64, device=dev)
        rank = rank - torch.searchsorted(bucket, bucket)
        while bucket.shape[0] and int(rank.max()) > 0:
            even = torch.nonzero(rank % 2 == 0).reshape(-1)
            nxt = torch.clamp(even + 1, max=bucket.shape[0] - 1)
            partner = (even + 1 < bucket.shape[0]) & (bucket[nxt] == bucket[even])
            Q = tuple(a[..., nxt] for a in P)
            Q = (Q[0], Q[1], self.fk.select(partner, Q[2],
                                            torch.zeros_like(Q[2])))
            P = ck.add(tuple(a[..., even] for a in P), Q)
            bucket, rank = bucket[even], rank[even] // 2
        out = ck.zero((num_buckets,), dev)
        return tuple(o.index_copy(-1, bucket, a) for o, a in zip(out, P))

    def window_sums_segments(self, points_aff, scalars, c: int):
        """Window sums through ``bucket_reduce`` (the result of the JAX
        ``window_sums_fused``)."""
        fk = self.fk
        lead = (2, fk.N) if ext_of(fk) == 2 else (fk.N,)
        B = 1 << (c - 1)
        seg = self.bucket_segments(scalars, c)
        W = seg["W"]
        rows = self.row_table(points_aff)
        flat = bucket_reduce(fk, rows, seg["gidx"], seg["seg_start"],
                             seg["seg_count"], seg["seg_order"])
        sums = self._combine_segments(
            tuple(a.reshape(lead + (a.shape[-1],)) for a in flat),
            seg["seg_bucket"], seg["num_buckets"])
        buckets = tuple(a.reshape(lead + (W, B + 1)) for a in sums)
        return self._aggregate_buckets(buckets, B)

    def _aggregate_buckets(self, buckets, B: int):
        """(.., W, B+1) bucket sums -> sum_j j*S_j per window, (W, .., 1):
        sum_{j>=1} T_j with T the suffix sums."""
        T = self._suffix_scan_add(buckets, B + 1)
        S_w = self._tree_reduce_points(_tree_map(lambda a: a[..., 1:], T))
        return _tree_map(lambda a: a.movedim(-2, 0), S_w)   # (W, lead, 1)

    # --------------------------------------------------------- dense strategy
    def dense_depth(self, m: int, nb: int, groups: int,
                    lanes_per_depth: int) -> int:
        """Chunk depth R of the dense layout for ``groups`` buckets of mean
        occupancy m / nb: the mean plus the extreme-value bound on a
        near-binomial maximum, sqrt(2 var ln n), times 1.35, plus slack (the
        JAX package's choice: a tight R with a rare second chunk), capped so
        that one chunk of ``lanes_per_depth`` * R lanes stays within
        ``DENSE_CHUNK_BYTES`` on the card; even, for a clean tree."""
        mean = m / max(1, nb)
        R = int(mean + 1.35 * math.sqrt(
            2.0 * max(mean, 1.0) * math.log(max(groups, 2))) + 8)
        R = min(max(R, 8), max(m, 2))
        FW = ext_of(self.fk) * self.fk.N
        cap = DENSE_CHUNK_BYTES // (32 * FW)
        R = min(R, max(16, cap // max(1, lanes_per_depth)))
        return R + R % 2

    def _dense_reduce(self, rows, gidx, starts, counts, m: int, w_lo: int,
                      w_hi: int, nb: int, R: int):
        """Bucket sums of windows [w_lo, w_hi) over buckets [0, nb): runs
        gathered R rows at a time into a (R, windows, buckets) layout --
        depth leading, so that the halves of every tree level are
        contiguous slabs -- level 0 by ``aadd`` on affine rows, the rest
        by the ``add`` tree; a bucket deeper than R takes further chunks.
        Returns Jacobian sums with batch shape (w_hi - w_lo, nb)."""
        ck, fk = self.ck, self.fk
        FW = ext_of(fk) * fk.N
        lead = (2, fk.N) if ext_of(fk) == 2 else (fk.N,)
        Wn = w_hi - w_lo
        dev = rows.device
        st = starts[w_lo:w_hi, :nb]
        ct = counts[w_lo:w_hi, :nb]
        max_count = int(ct.max()) if ct.numel() else 0
        woff = (torch.arange(w_lo, w_hi, dtype=torch.int64, device=dev)
                * m)[None, :, None]
        r_idx = torch.arange(R, dtype=torch.int64, device=dev)[:, None, None]
        half = R // 2
        out = ck.zero((Wn, nb), dev)
        for base in range(0, max_count, R):
            depth = base + r_idx                              # (R, 1, 1)
            pos = torch.clamp(st[None] + depth, 0, m - 1)     # (R, Wn, nb)
            live = (depth < ct[None]).reshape(R, Wn * nb)
            rg = gidx[(woff + pos).reshape(-1)]
            gt = words_to_limbs(rows[rg].T)                   # (2FW, K)
            qx = gt[:FW].reshape(lead + (R, Wn * nb))
            qy = gt[FW:].reshape(lead + (R, Wn * nb))
            qinf = (gt[FW:] == 0).all(dim=0).reshape(R, Wn * nb) | ~live
            lo = (qx.narrow(-2, 0, half), qy.narrow(-2, 0, half), qinf[:half])
            hi = (qx.narrow(-2, half, half), qy.narrow(-2, half, half),
                  qinf[half:])
            P = self._tree_reduce_points(ck.aadd(lo, hi), axis=-2)
            out = ck.add(out, _tree_map(
                lambda a: a.reshape(lead + (Wn, nb)), P))
        return out

    def window_sums_dense(self, points_aff, scalars, c: int):
        """Window sums through the dense bucket layout (the port of the JAX
        ``window_sums_dense``); ``dense_depth`` gives the chunk depths.

        Full windows share one (depth, windows, buckets) shape. A partial
        top window covers eff < c scalar bits, so its digits land in about
        2^eff buckets of occupancy m / 2^eff: it gets its own bucket count
        and depth. A zero-width window behind a partial one holds only zero
        digits (signed-digit carries escape full windows only)."""
        ck = self.ck
        m = scalars.shape[-1]
        B = 1 << (c - 1)
        digits, signs = self.signed_digits(scalars, c)         # (W, m)
        W = digits.shape[0]
        gidx, starts, counts = self._sort_signed_bounds(digits, signs, m, B)
        gidx = gidx.reshape(-1)
        rows = self.row_table(points_aff, signed=True)          # (2m, FW)
        dev = rows.device

        W_full = min(W, self.scalar_bits // c)
        groups = []
        if W_full > 0:
            R = self.dense_depth(m, B, W * B, W_full * (B + 1))
            groups.append(self._dense_reduce(rows, gidx, starts, counts, m,
                                             0, W_full, B + 1, R))
        for w in range(W_full, W):
            eff = max(0, min(c, self.scalar_bits - c * w))
            prev_eff = max(0, min(c, self.scalar_bits - c * (w - 1)))
            if eff == 0 and prev_eff < c:
                groups.append(ck.zero((1, B + 1), dev))
                continue
            nb = min(B + 1, (1 << eff) + 2)         # digits <= 2^eff + carry
            Rw = self.dense_depth(m, max(1, nb - 2), nb, nb)
            row = self._dense_reduce(rows, gidx, starts, counts, m, w, w + 1,
                                     nb, Rw)
            if nb < B + 1:
                zpt = ck.zero((1, B + 1 - nb), dev)
                row = tuple(torch.cat([a, z], dim=-1)
                            for a, z in zip(row, zpt))
            groups.append(row)
        buckets = _tree_map(lambda *gs: torch.cat(gs, dim=-2), *groups)
        return self._aggregate_buckets(buckets, B)

    def combine_windows(self, S, c: int):
        """Horner combine of per-window sums: sum_w 2^(cw) S_w, ONE
        ``horner_combine`` launch on the card."""
        fk = self.fk
        FW = ext_of(fk) * fk.N
        W = S[0].shape[0]
        flat = tuple(a.movedim(0, -2)[..., 0].reshape(FW, W) for a in S)
        out = horner_combine(fk, flat, c)
        if ext_of(fk) == 2:
            return tuple(a.reshape(2, fk.N, 1) for a in out)
        return out

    # ------------------------------------------------------------ fixed base
    def window_table(self, base_aff, c: int, num_windows: int):
        """Device-built fixed-base table: T[w, j] = j * 2^(c w) * base.

        base_aff: (x, y) single affine point with batch shape (1,).
        Returns a Jacobian table with batch shape (num_windows, 2^c).
        """
        ck = self.ck
        g = (base_aff[0], base_aff[1],
             self.fk.one((1,), base_aff[0].device))
        gs = []
        for w in range(num_windows):
            gs.append(g)
            if w + 1 < num_windows:
                g = ck.dbl_n(g, c)
        # (.., 1) per window -> (.., W, 1) -> lanes j = 0 .. 2^c - 1
        L = 1 << c
        rep = tuple(torch.stack([gw[k] for gw in gs], dim=-2)
                    .expand(gs[0][k].shape[:-1] + (num_windows, L))
                    .contiguous() for k in range(3))
        X, Y, Z = rep
        Z = Z.clone()
        Z[..., 0] = 0                       # lane 0 = infinity
        T = (X, Y, Z)
        for k in range(max(1, (L - 1).bit_length())):
            s = 1 << k

            def sh(a):
                pad = torch.zeros(a.shape[:-1] + (s,), dtype=a.dtype,
                                  device=a.device)
                return torch.cat([pad, a[..., :L - s]], dim=-1)
            T = ck.add(T, tuple(sh(a) for a in T))
        return T

    def fixed_base_rows(self, table_aff):
        """The packed row table of an affine window table (batch (W, 2^c)):
        (W 2^c, FW) rows, row w 2^c + j = T[w, j], what ``madd_windows``
        reads."""
        x, y, inf = table_aff
        return self.row_table(tuple(a.reshape(a.shape[:-2] + (-1,))
                                    for a in (x, y, inf)))

    def batch_exp(self, table_aff, scalars, c: int, rows=None):
        """Fixed-base exponentiation: out[i] = scalars[i] * base.

        table_aff: affine table (x, y, inf) with batch (num_windows, 2^c)
        from ``window_table`` + ``to_affine``; rows: its
        ``fixed_base_rows`` where the caller keeps them. scalars: (NL, m)
        plain limbs. Returns a Jacobian batch (m,): ONE ``madd_windows``
        launch on the card (its plain version on CPU tensors), the limbs of
        the JAX package's scan. A curve with an a-coefficient takes
        ``batch_exp_loop``."""
        if self.ck.mul_by_a is not None:
            return self.batch_exp_loop(table_aff, scalars, c)
        if rows is None:
            rows = self.fixed_base_rows(table_aff)
        return madd_windows(self.fk, rows, scalars, c)

    def batch_exp_loop(self, table_aff, scalars, c: int):
        """The same scan as one gather and one ``madd`` launch a window:
        the form the windowed kernel replaced, kept as its yardstick."""
        return windows_scan(self.fk, table_aff, scalars, c, self.ck.madd)


def msm_host_scalars(msm_kernel, points_aff, scalar_ints, r, c=None):
    """Convenience: python-int scalars -> device MSM."""
    nl = -(-r.bit_length() // LIMB_BITS)
    sc = torch.from_numpy(ints_to_limbs([s % r for s in scalar_ints], nl)
                          .astype("int32")).to(points_aff[0].device)
    return msm_kernel.msm(points_aff, sc, c)
