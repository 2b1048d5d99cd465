"""Batched field, curve, MSM and NTT code over limb tensors.

Kernel wrappers (each counts its launches on the card, per coordinate
field and field width):
  cuda_fp.mont_mul                       csrc/fp.cu
  cuda_ec.dbl / add / madd / aadd        csrc/ec.cu
  cuda_bucket.bucket_reduce / horner     csrc/bucket.cu
The probe kernels (csrc/probe.cu, csrc/probe_layout.cu) count in
``libsnark_tpu_torch.probes``.
"""
from . import cuda_bucket, cuda_ec, cuda_fp

_COUNTERS = (cuda_fp.LAUNCHES, cuda_ec.LAUNCHES, cuda_bucket.LAUNCHES)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts():
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
