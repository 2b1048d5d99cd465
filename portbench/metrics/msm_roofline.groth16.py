"""The least time of a proof's five MSMs (workcount.py, from the inputs)
over the time they took, in %."""
from portbench.readers import roofline

SPANS = ("msm_A", "msm_B_g2", "msm_B_g1", "msm_H", "msm_L")


def read(run):
    return roofline(run, SPANS)
