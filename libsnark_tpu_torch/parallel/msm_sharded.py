"""Multi-device MSM: points sharded over a ``torch.distributed`` process
group (the port of libsnark_tpu/parallel/msm_sharded.py).

The reference's only parallelism is OpenMP chunking of the bucket loop
(multi_exp(..., chunks=omp_get_max_threads()), r1cs_gg_ppzksnark.tcc:
308-314). Here every rank of the group runs the whole per-window bucket
pipeline (``MSMKernel.window_sums``) on its contiguous lane shard; the
per-window partial sums -- O(W) points, tiny -- are ``all_gather``-ed and
every rank reduces them with one halving point-add tree
(``_tree_reduce_points``), then runs one Horner window combine. Group
addition is no reduction a collective can do, so the collective moves only
W points a rank.

The call is SPMD: every rank calls it with the same global queries and
scalars and reads only its own shard [r m/D, (r+1) m/D). The result is
replicated on every rank. On the card the group is NCCL; gloo is for CPU
tensors only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def shard_bounds(m: int, group=None):
    """[lo, hi) of this rank's contiguous shard of m lanes."""
    D = dist.get_world_size(group)
    r = dist.get_rank(group)
    if m % D:
        raise ValueError(f"{m} lanes do not split over {D} ranks "
                         "(pad_for_mesh first)")
    s = m // D
    return r * s, (r + 1) * s


def sharded_msm(msm_kernel, group, points_aff, scalars, c: int = 8,
                affine: bool = False, method: str = "pippenger"):
    """MSM with the batch (last) axis of points and scalars split over the
    ranks of ``group`` (None: the world group).

    points_aff: (x, y, inf) global tensors; scalars (NL, m) plain limbs.
    Returns a Jacobian point (batch (1,)), the same on every rank -- or
    affine (x, y, inf) when ``affine=True``.

    method="simple" runs the double-and-add local MSM
    (``MSMKernel.msm_simple``) under the same sharding and collective.
    """
    lo, hi = shard_bounds(scalars.shape[-1], group)
    pts = tuple(a[..., lo:hi] for a in points_aff)
    sc = scalars[..., lo:hi]
    if method == "simple":
        S = msm_kernel.msm_simple(pts, sc)              # batch (1,)
        S = tuple(a[..., None, :] for a in S)           # (.., 1, 1)
        out = tuple(a[..., 0, :] for a in _gather_tree_add(
            msm_kernel, group, S))
    elif method == "pippenger":
        S = msm_kernel.window_sums(pts, sc, c)          # (W, .., 1)
        # the window axis into the batch position for the cross-rank adds
        S = tuple(a.movedim(0, -2) for a in S)          # (.., W, 1)
        acc = _gather_tree_add(msm_kernel, group, S)
        out = msm_kernel.combine_windows(
            tuple(a.movedim(-2, 0) for a in acc), c)
    else:
        raise ValueError(f"unknown sharded MSM method {method!r}")
    return msm_kernel.ck.to_affine(out) if affine else out


def _gather_tree_add(msm_kernel, group, S):
    """all_gather each rank's partial sums (each (.., K, 1)) and reduce
    across ranks with the kernel's log-depth point tree. Returns
    (.., K, 1)."""
    D = dist.get_world_size(group)
    lanes = []
    for a in S:
        a = a.contiguous()
        parts = [torch.empty_like(a) for _ in range(D)]
        dist.all_gather(parts, a, group=group)
        lanes.append(torch.stack(parts, dim=-1)[..., 0, :])   # (.., K, D)
    return msm_kernel._tree_reduce_points(tuple(lanes))


def pad_for_mesh(points_aff, scalars, mult: int):
    """Pad the batch axis to a multiple of ``mult`` with infinity points
    and zero scalars (the shards must be even)."""
    m = scalars.shape[-1]
    pad = (-m) % mult
    if pad == 0:
        return points_aff, scalars
    x, y, inf = points_aff

    def padlast(a, val=0):
        return torch.nn.functional.pad(a, (0, pad), value=val)

    inf = torch.cat([inf, torch.ones(inf.shape[:-1] + (pad,),
                                     dtype=inf.dtype, device=inf.device)],
                    dim=-1)
    return (padlast(x), padlast(y), inf), padlast(scalars)
