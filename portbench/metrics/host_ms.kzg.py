"""Host path of a commit and open (polynomial_commitments/kzg10.py):
the two encodes, the Horner evaluation and the two decodes, ms a
polynomial."""
from portbench.readers import mean_ms

SPANS = ("kzg.commit.encode", "kzg.commit.decode", "kzg.open.evaluate",
         "kzg.open.encode", "kzg.open.decode")


def read(run):
    return mean_ms(run, SPANS)
