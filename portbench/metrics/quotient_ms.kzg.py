"""The opening's quotient by coset FFTs (KZG10.quotient, ops/ntt.py), ms a
polynomial."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, ("kzg.open.quotient",))
