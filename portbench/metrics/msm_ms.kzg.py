"""The commitment's and the witness's MSMs (ops/msm.py), ms a
polynomial."""
from portbench.readers import mean_ms

SPANS = ("kzg.commit.msm", "kzg.open.msm")


def read(run):
    return mean_ms(run, SPANS)
