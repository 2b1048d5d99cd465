"""Seconds from the start of the process to the first timed request:
imports, the card, the extensions, the inputs, the keys and the warm-up."""


def read(run):
    return run.setup_s
