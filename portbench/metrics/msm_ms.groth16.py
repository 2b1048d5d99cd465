"""The five MSMs of a proof (ops/msm.py), each to its affine result, ms
a proof."""
from portbench.readers import mean_ms

SPANS = ("msm_A", "msm_B_g2", "msm_B_g1", "msm_H", "msm_L")


def read(run):
    return mean_ms(run, SPANS)
