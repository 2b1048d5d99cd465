"""The profile_* front-ends of the port (the reference's profile_*
executables; the port of the repo's profiles/): each module runs as
``python -m libsnark_tpu_torch.profiles.<name> [arguments] [--device
cuda|cpu]`` and has ``main(argv=None) -> int``."""
