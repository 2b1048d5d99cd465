"""The share of the commit and open window in which the device ran
nothing, in % (torch.profiler)."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
