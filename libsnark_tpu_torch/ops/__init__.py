"""Batched field, curve, MSM and NTT code over limb tensors.

Kernel wrappers (each counts its launches on the card and their work, per
coordinate field and field width):
  cuda_fp.mont_mul                       csrc/fp.cu
  cuda_ec.dbl / add / madd / aadd        csrc/ec.cu
  cuda_bucket.bucket_reduce / horner     csrc/bucket.cu
The probe kernels (csrc/probe.cu, csrc/probe_layout.cu) count in
``libsnark_tpu_torch.probes``.
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


def reset_launch_counts():
    """Zero the launch counts and the work counts."""
    for c in _COUNTERS + _WORK:
        for k in c:
            c[k] = 0
