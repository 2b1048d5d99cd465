"""Polynomials committed and opened in the window, over its seconds."""
from portbench.readers import rate


def read(run):
    return rate(run)
