"""The demo front-ends of the port (the reference's demo executables; the
port of the repo's demos/): each module runs as ``python -m
libsnark_tpu_torch.demos.<name> [arguments] [--device cuda|cpu]`` and has
``main(argv=None) -> int``."""
