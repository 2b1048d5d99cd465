"""The benchmark's cells at sizes a CPU test can hold."""
from portbench import run
from portbench.generate import load_module

SMALL = {"groth16": {"num_constraints": (1 << 6) - 11},
         "kzg10": {"degree": (1 << 8) - 1}}
GROTH16 = "groth16_bls12_377_2e20.dense"
KZG = "kzg10_bls12_377_2e22.commit_open"


def small_cell(name: str, **sizes) -> tuple:
    """(bench, cell, config, traffic) with the configuration cut to a
    small size (``sizes`` overrides the default cut)."""
    bench, cell, config, traffic = run.load_cell(name)
    config = dict(config, **SMALL[config["system"]], **sizes)
    return bench, cell, config, traffic


def run_small(name: str, seed: int = 12345678901, seconds: float = 0.2,
              trace: bool = False, serve: str = "program", **sizes) -> dict:
    bench, cell, config, traffic = small_cell(name, **sizes)
    return run.run_cell(bench, cell, config, traffic, seed, seconds, trace,
                        device="cpu", serve=serve)


def load_system(workload: str, seed: int, device: str = "cpu", **sizes):
    """The cell's ``System`` with its configuration cut to ``sizes``."""
    bench, cell, config, traffic = run.load_cell(workload)
    config = dict(config, **sizes)
    mod = load_module(run.PB / "systems" / f"{config['system']}.py",
                      f"portbench_system_{config['system']}")
    return mod.System(config, traffic, seed, device)
