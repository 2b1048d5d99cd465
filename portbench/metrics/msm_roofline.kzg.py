"""The least time of a polynomial's two MSMs (workcount.py, from the
inputs) over the time they took, in %."""
from portbench.readers import roofline

SPANS = ("kzg.commit.msm", "kzg.open.msm")


def read(run):
    return roofline(run, SPANS)
