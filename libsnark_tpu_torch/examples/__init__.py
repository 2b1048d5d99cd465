"""Examples of the port (the port of the repo's examples/): each module
runs as ``python -m libsnark_tpu_torch.examples.<name>`` and has
``main(argv=None) -> int``."""
