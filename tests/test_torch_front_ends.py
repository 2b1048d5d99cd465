"""The port's front-ends (libsnark_tpu_torch/{profiles,demos,examples}) on
the CPU: one counterpart for every JAX front-end file, the argv contract
(``parse_std_args``, ``--device``), the refusal to run without a card
unless ``--device cpu`` is given, and the R1CS-family profiles.

* The Groth16 profile at 20 constraints and 3 inputs: its proof equals,
  bit for bit, the port's ``Groth16(..., device="cpu")`` proof at the same
  seeds (generator 1, prover 2) on the same ``generate_r1cs_example``
  circuit; its vk and proof, written by the port's ``Codec`` and read by
  the JAX package's, are accepted by the JAX package's host verifier,
  which rejects a changed input. (The port's Groth16 is held against the
  JAX prover in tests/test_torch_groth16.py.)
* BCTV14, GM17, DFGK14, BACS and TBCS profiles at 2^6-scale sizes: exit 0,
  ``PASS``, and ``FAIL (expected)`` for the changed input where the JAX
  script prints it (keys made on the host, ``PairingSystem.host_keygen``:
  the same points as the device path, in less time on the CPU).

The JAX front-ends themselves are never imported here: each one pops
JAX_PLATFORMS and PYTHONPATH from the environment at import. Tolerance:
zero.
"""
import ast
import contextlib
import importlib
import inspect
import io
import pathlib

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.groth16 import Groth16 as JaxGroth16
from libsnark_tpu.serialization import Codec as JaxCodec

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.profiles import _common
from libsnark_tpu_torch.profiles import profile_r1cs_gg_ppzksnark
from libsnark_tpu_torch.proof_systems.base import PairingSystem
from libsnark_tpu_torch.proof_systems.groth16 import Groth16
from libsnark_tpu_torch.relations.examples import generate_r1cs_example
from libsnark_tpu_torch.serialization import Codec

from _torch_port import coords

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_FRONT_ENDS = sorted(
    [p.relative_to(REPO) for p in (REPO / "profiles").glob("profile_*.py")]
    + [p.relative_to(REPO) for p in (REPO / "demos").glob("*.py")]
    + [p.relative_to(REPO) for p in (REPO / "examples").glob("*.py")])


def port_module(rel: pathlib.PurePath) -> str:
    return "libsnark_tpu_torch." + ".".join(rel.with_suffix("").parts)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_twenty_jax_front_ends():
    assert len(JAX_FRONT_ENDS) == 20, JAX_FRONT_ENDS


@pytest.mark.parametrize("rel", JAX_FRONT_ENDS, ids=str)
def test_front_end_has_a_port(rel):
    """The counterpart of each JAX front-end file exists, imports and has
    main(argv=None)."""
    mod = importlib.import_module(port_module(rel))
    assert callable(mod.main)
    params = inspect.signature(mod.main).parameters
    assert "argv" in params and params["argv"].default is None


def _writes_environ(tree) -> list:
    """Lines where a module writes the process environment."""
    def is_environ(node):
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")
    bad = []
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, (ast.Assign, ast.Delete)):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        if any(isinstance(t, ast.Subscript) and is_environ(t.value)
               for t in targets):
            bad.append(node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if is_environ(f.value) and f.attr in (
                    "pop", "popitem", "update", "setdefault", "clear",
                    "__setitem__", "__delitem__"):
                bad.append(node.lineno)
            if (isinstance(f.value, ast.Name) and f.value.id == "os"
                    and f.attr in ("putenv", "unsetenv")):
                bad.append(node.lineno)
    return bad


def test_port_writes_no_environment_variable():
    files = sorted((REPO / "libsnark_tpu_torch").rglob("*.py"))
    assert REPO / "libsnark_tpu_torch/profiles/_common.py" in files
    for f in files + [REPO / "chip_smoke.py"]:
        assert not _writes_environ(ast.parse(f.read_text())), f
    # the check sees the JAX front-ends' writes
    assert _writes_environ(ast.parse((REPO / "profiles/_common.py")
                                     .read_text()))


# ------------------------------------------------------------- argv

@pytest.mark.parametrize("args,want", [
    ([], (1000, 10)), (["64", "5"], (64, 5)), (["64", "5", "Fr"], (64, 5)),
    # 100 bytes in 253-bit elements: ceil(800 / 253)
    (["64", "100", "bytes"], (64, 4)), (["64", "32", "bytes"], (64, 2))])
def test_parse_std_args(args, want):
    assert _common.parse_std_args(args) == want


@pytest.mark.parametrize("args", [["64"], ["1", "2", "3", "4"],
                                  ["64", "5", "words"]])
def test_parse_std_args_refuses_bad_arguments(args, capsys):
    with pytest.raises(SystemExit) as e:
        _common.parse_std_args(args, prog="profile_x")
    assert e.value.code == 1
    assert capsys.readouterr().out.startswith(
        "usage: profile_x num_constraints input_size [Fr|bytes]")


@pytest.mark.parametrize("argv,want", [
    (["20", "3"], ("cuda", ["20", "3"])),
    (["20", "--device", "cpu", "3"], ("cpu", ["20", "3"])),
    (["--device=cuda", "7"], ("cuda", ["7"])),
    (["d", "--backend=cycle", "--device", "cpu"],
     ("cpu", ["d", "--backend=cycle"]))])
def test_split_device(argv, want):
    assert _common.split_device(argv) == want


def test_split_device_refuses_other_devices():
    with pytest.raises(SystemExit):
        _common.split_device(["--device", "tpu"])


@pytest.mark.parametrize("module,argv", [
    ("profiles.profile_r1cs_gg_ppzksnark", ["20", "3"]),
    ("profiles.profile_ram_zksnark", ["--backend=transcript"]),
    ("profiles.profile_r1cs_sp_ppzkpcd_cycle", ["1"]),
    ("demos.demo_ram_ppzksnark_generator", ["{tmp}"]),
    ("demos.demo_r1cs_ppzkadsnark", ["20", "3"]),
    ("examples.tutorial_gadgetlib2", [])])
def test_front_end_refuses_to_run_without_a_card(module, argv, tmp_path,
                                                 monkeypatch, capsys):
    """Without a CUDA device and without --device cpu a front-end fails
    with an error that names the device, before any work: nothing is
    printed past its header, nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    mod = importlib.import_module(f"libsnark_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        mod.main([a.format(tmp=out) for a in argv])
    assert not out.exists()
    assert "verification" not in capsys.readouterr().out


# -------------------------------------------------------- Groth16 profile

@pytest.fixture(scope="module")
def groth16_profile():
    res = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_r1cs_gg_ppzksnark.main(
            ["20", "3", "--device", "cpu"], result=res) == 0
    res["stdout"] = out.getvalue()
    return res


def test_groth16_profile_proof_equals_the_api_proof(groth16_profile):
    res = groth16_profile
    curve = get_curve("alt_bn128")
    cs, primary, aux = generate_r1cs_example(curve.r, 20, 3)
    assert (res["primary"], res["auxiliary"]) == (primary, aux)
    g16 = Groth16(curve, device="cpu")
    kp = g16.generator(cs, seed=1)
    assert coords(kp.vk) == coords(res["keypair"].vk)
    proof = g16.prover(kp.pk, primary, aux, seed=2)
    assert coords(proof) == coords(res["proof"])


def test_groth16_profile_files_verify_in_the_jax_package(groth16_profile):
    """vk and proof through the port's Codec, read by the JAX package's,
    accepted by its host verifier; a changed input rejected."""
    res = groth16_profile
    c = Codec(get_curve("alt_bn128"))
    vk_txt = c.dumps(c.write_groth16_vk, res["keypair"].vk)
    proof_txt = c.dumps(c.write_groth16_proof, res["proof"])
    jc = jax_get_curve("alt_bn128")
    jcodec = JaxCodec(jc)
    jvk = jcodec.loads(jcodec.read_groth16_vk, vk_txt)
    jproof = jcodec.loads(jcodec.read_groth16_proof, proof_txt)
    jg16 = JaxGroth16(jc)
    primary = res["primary"]
    assert jg16.verifier_strong_IC(jvk, primary, jproof)
    assert not jg16.verifier_strong_IC(
        jvk, [(primary[0] + 1) % jc.r] + primary[1:], jproof)


def test_groth16_profile_prints_its_verdicts(groth16_profile):
    out = groth16_profile["stdout"]
    for block in ("Generate R1CS example", "Generator", "Prover",
                  "Serialization round trip", "Verifier"):
        assert f"(leave) {block}  [" in out, block
    assert "verification result: PASS" in out
    assert "tampered-input result: FAIL (expected)" in out


# ------------------------------------------------- the other R1CS profiles

@pytest.mark.parametrize("module,argv,tampered", [
    ("profile_r1cs_ppzksnark", ["61", "3"], True),
    ("profile_r1cs_se_ppzksnark", ["61", "3"], True),
    ("profile_uscs_ppzksnark", ["64", "3"], True),
    ("profile_bacs_ppzksnark", ["64", "4"], False),
    ("profile_tbcs_ppzksnark", ["64", "4"], False)])
def test_r1cs_family_profiles(module, argv, tampered, capsys, monkeypatch):
    monkeypatch.setattr(PairingSystem, "host_keygen", True)
    mod = importlib.import_module(f"libsnark_tpu_torch.profiles.{module}")
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "verification result: PASS" in out
    assert ("tampered-input result: FAIL (expected)" in out) == tampered
    assert "BUG" not in out
