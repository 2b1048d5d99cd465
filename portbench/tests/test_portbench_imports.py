"""Nothing a run imports has the top-level name jax, jaxlib, flax or
libsnark_tpu (compared whole: libsnark_tpu_torch begins with
libsnark_tpu), and the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

PB = run.PB


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_harness_imports_jax():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        bad = _imports(path) & {"libsnark_tpu_torch", "torch",
                                *run.FORBIDDEN}
        assert not bad, (path, bad)


def test_a_run_loads_no_forbidden_module():
    """Every module a run loads (the harness, each system with the
    program's modules it drives, each metric), in a fresh process."""
    code = f"""
import sys
sys.path.insert(0, {str(PB.parent)!r})
from portbench import run, control
from portbench.generate import load_module
for kind in ("systems", "metrics", "circuits"):
    for p in sorted((run.PB / kind).glob("*.py")):
        load_module(p, "m_" + kind + "_" + p.stem)
from libsnark_tpu_torch.curves import get_curve
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.polynomial_commitments.kzg10 import KZG10
from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
Groth16(get_curve("bls12_377"), device="cpu")
print("forbidden:" + ",".join(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["libsnark_tpu_torch.ops.msm", "jaxtyping",
                                  "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["libsnark_tpu.ops", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                     "libsnark_tpu"]
