"""The port's Groth16 slice as a whole vs the JAX package.

Circuit and seeds of tests/test_groth16.py::test_groth16_deterministic_with_seed
(generate_r1cs_example(r, 20, 2), generator seed 5, prover seed 9). The
JAX keypair (host fixed-base path: the same affine points as its device
path) and proof are built once per module. The port, on the CPU (plain
versions of every kernel), must give the same proof bit for bit, both
from the proving key carried across as numpy and from its own generator
(device fixed-base path), whose queries must equal the JAX ones limb for
limb. The port's verifier accepts the proof and rejects a corrupted proof
and a wrong input.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.relations.examples import generate_r1cs_example as jax_example

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.interop import QUERIES, proving_key_from_numpy
from libsnark_tpu_torch.ops.limbs import from_torch
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.relations.examples import generate_r1cs_example

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g1(P):
    return None if P.is_zero() else (int(P.x), int(P.y))


def _g2(P):
    if P.is_zero():
        return None
    return ((int(P.x.c0), int(P.x.c1)), (int(P.y.c0), int(P.y.c1)))


def _proof_coords(proof):
    return (_g1(proof.g_A), _g2(proof.g_B), _g1(proof.g_C))


@pytest.fixture(scope="module")
def jax_run():
    curve = jax_get_curve("alt_bn128")
    cs, primary, aux = jax_example(curve.r, 20, 2)
    g16 = JaxGroth16(curve)
    g16.host_keygen = True
    kp = g16.generator(cs, seed=5)
    proof = g16.prover(kp.pk, primary, aux, seed=9)
    return dict(kp=kp, proof=proof, primary=primary, aux=aux)


@pytest.fixture(scope="module")
def port():
    return Groth16(get_curve("alt_bn128"), device="cpu")


def _carried_pk(port, jkp):
    pk = jkp.pk
    dev = pk.r1cs_dev
    queries = {q: tuple(np.asarray(a) for a in getattr(pk, q))
               for q in QUERIES}
    points = {"alpha_g1": _g1(pk.alpha_g1), "beta_g1": _g1(pk.beta_g1),
              "delta_g1": _g1(pk.delta_g1), "beta_g2": _g2(pk.beta_g2),
              "delta_g2": _g2(pk.delta_g2)}
    matrices = {k: (m.rows, m.cols, m.coeffs)
                for k, m in (("A", dev.A), ("B", dev.B), ("C", dev.C))}
    return proving_key_from_numpy(port, queries, points, matrices,
                                  dev.num_constraints, dev.num_inputs,
                                  dev.num_variables)


@pytest.fixture(scope="module")
def port_own(port):
    cs, primary, aux = generate_r1cs_example(port.curve.r, 20, 2)
    kp = port.generator(cs, seed=5)
    return kp, port.prover(kp.pk, primary, aux, seed=9)


def test_proof_from_carried_pk_equals_jax(port, jax_run):
    pk = _carried_pk(port, jax_run["kp"])
    proof = port.prover(pk, jax_run["primary"], jax_run["aux"], seed=9)
    assert _proof_coords(proof) == _proof_coords(jax_run["proof"])


def test_own_generator_keys_equal_jax(port_own, jax_run):
    kp, _ = port_own
    jpk = jax_run["kp"].pk
    for q in QUERIES:
        for got, want in zip(getattr(kp.pk, q), getattr(jpk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want))
    for name in ("alpha_g1", "beta_g1", "delta_g1"):
        assert _g1(getattr(kp.pk, name)) == _g1(getattr(jpk, name))
    for name in ("beta_g2", "delta_g2"):
        assert _g2(getattr(kp.pk, name)) == _g2(getattr(jpk, name))
    jvk = jax_run["kp"].vk
    assert [_g1(P) for P in kp.vk.gamma_ABC] == [_g1(P) for P in jvk.gamma_ABC]


def test_proof_from_own_generator_equals_jax(port_own, jax_run):
    _, proof = port_own
    assert _proof_coords(proof) == _proof_coords(jax_run["proof"])


def test_port_verifier_accepts_and_rejects(port, port_own, jax_run):
    kp, proof = port_own
    primary = jax_run["primary"]
    r = port.curve.r
    assert port.verifier_strong_IC(kp.vk, primary, proof)
    bad = [(primary[0] + 1) % r] + primary[1:]
    assert not port.verifier_strong_IC(kp.vk, bad, proof)
    tam = type(proof)(g_A=proof.g_A, g_B=proof.g_B,
                      g_C=proof.g_C + port.curve.G1.one())
    assert not port.verifier_strong_IC(kp.vk, primary, tam)
    assert not port.verifier_strong_IC(kp.vk, primary[:1], proof)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "libsnark_tpu_torch").rglob("*.py"))
    # the gadget layer, the PCD systems, Fp3, the curves with an
    # a-coefficient, the RAM systems, the cycle systems, the host formats,
    # the multi-device prover and the digit-matrix NTT among them
    for sub in ("gadgets/verifier_gadgets.py", "gadgets/hashes/knapsack.py",
                "proof_systems/pcd.py", "proof_systems/mp_pcd.py",
                "ops/fp3.py", "curves/mnt.py", "curves/edwards.py",
                "relations/tinyram.py", "relations/fooram.py",
                "relations/memory.py", "common/integer_permutation.py",
                "common/routing.py", "gadgets/routing_gadgets.py",
                "gadgets/tinyram_cpu_checker.py",
                "gadgets/fooram_checker.py", "gadgets/ram_universal.py",
                "relations/examples.py", "proof_systems/ram_ppzksnark.py",
                "proof_systems/ram_zksnark.py", "gadgetlib2.py",
                "interop.py", "gadgets/gadget_from_r1cs.py",
                "proof_systems/pcd_cycle.py", "proof_systems/mp_pcd_cycle.py",
                "default_types.py", "gadgets/kzg10_verifier_gadget.py",
                "gadgets/bctv14_verifier_gadget.py", "libsnark_compat.py",
                "compat_spec_decoder.py", "serialization.py",
                "parallel/msm_sharded.py", "parallel/ntt_sharded.py",
                "ops/ntt_mxu.py"):
        assert REPO / "libsnark_tpu_torch" / sub in files, sub
    files.append(REPO / "chip_smoke.py")
    files.append(REPO / "scripts" / "probe_h100.py")
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "libsnark_tpu"), (f, mod)
    mods = [".".join(f.relative_to(REPO).with_suffix("").parts)
            for f in files if f.name != "__init__.py"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'libsnark_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    curve = get_curve("alt_bn128")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16(curve)
    from libsnark_tpu_torch.ops.fp import FpKernel
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FpKernel(curve.fr_params)
