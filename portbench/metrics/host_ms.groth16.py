"""Host path of a proof (proof_systems/groth16.py): the encode of the
witness and the final combination on the host, ms a proof."""
from portbench.readers import mean_ms

SPANS = ("prove_encode", "prove_host_combine")


def read(run):
    return mean_ms(run, SPANS)
