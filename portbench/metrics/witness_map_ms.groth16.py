"""The QAP witness map of a proof (reductions/r1cs_to_qap.py over
ops/ntt.py), ms a proof."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, ("witness_map",))
