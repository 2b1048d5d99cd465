"""Batched field, curve, MSM and NTT code over limb tensors.

Kernel wrappers (each counts its launches on the card and their work, per
coordinate field and field width):
  cuda_fp.mont_mul / add_sub / mul_wide  csrc/fp.cu
  cuda_ec.dbl / add / madd / aadd        csrc/ec.cu
  cuda_ec.madd_windows / aadd_rows       csrc/ec.cu
  cuda_bucket.bucket_reduce / horner     csrc/bucket.cu
  cuda_bucket.dbl_chain                  csrc/bucket.cu
The probe kernels (csrc/probe.cu, csrc/probe_layout.cu) count in
``libsnark_tpu_torch.probes``, the MXU NTT's matrix products (torch's)
in ``ntt_mxu.MATMULS``.
"""
from . import cuda_bucket, cuda_ec, cuda_fp

_COUNTERS = (cuda_fp.LAUNCHES, cuda_ec.LAUNCHES, cuda_bucket.LAUNCHES)
_WORK = (cuda_fp.WORK, cuda_ec.WORK, cuda_bucket.WORK)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def work_counts() -> dict:
    """Kernel name -> work of its launches since the last reset (units in
    each wrapper module: lanes, doublings, madd rows, products)."""
    return {k: int(v) for c in _WORK for k, v in c.items()}


def depth_counts() -> dict:
    """Kernel name -> critical path of its launches since the last reset, in
    dependent base-field products (horner_combine and dbl_chain only)."""
    return {k: int(v) for k, v in cuda_bucket.DEPTH.items()}


def live_pair_counts() -> dict:
    """Kernel name -> output lanes of its launches since the last reset that
    ran the formula's products (aadd_rows only: both depths within their
    bucket's count)."""
    return {k: int(v) for k, v in cuda_ec.LIVE_PAIRS.items()}


def reset_launch_counts():
    """Zero the launch, work, depth and live-pair counts."""
    for c in _COUNTERS + _WORK + (cuda_bucket.DEPTH, cuda_ec.LIVE_PAIRS):
        for k in c:
            c[k] = 0
