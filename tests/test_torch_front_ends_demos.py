"""The port's file-driven, authentication and host-only front-ends on the
CPU.

* ``demo_ram_ppzksnark`` (all in one) and ``demo_arithmetization`` on the
  input files of tests/test_demos.py: the proof accepted; the universal
  circuit satisfied on the host and on the device R1CS.
* ``demo_r1cs_ppzkadsnark`` at 8 constraints: both verifications PASS; a
  bad arity exits 1.
* The gadgetlib2 tutorial: every example OK, its R1CS proved and verified
  with BCTV14.
* Both routing profiles at max_log 5: every network routes, every board
  is satisfied.
* ``RamZkSnark.prover`` without a timings dict, as ``profile_ram_zksnark``
  calls it (that path once raised KeyError), and with one.

Keys are made on the host (``PairingSystem.host_keygen``, the same points
as the device path: tests/test_torch_ram.py) to keep CPU keygen short.
"""
import contextlib
import importlib
import io
import types

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu_torch.proof_systems.base import PairingSystem

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_host_keygen():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PairingSystem, "host_keygen", True)
        yield
    torch.set_num_threads(n)


def run(main, argv, **kw):
    """(exit code, standard output) of a front-end's main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def _write_demo_inputs(d):
    """tests/test_demos.py's input files."""
    (d / "ap.txt").write_text("16 4\n")
    (d / "cb.txt").write_text("2 8 6\n")   # input, program, time bounds
    asm = "mov 1 0 0 7\nstorew 1 0 0 64\nloadw 1 1 0 64\nanswer 1 0 0 0\n"
    (d / "prog.txt").write_text(asm)
    (d / "prog.s").write_text(asm)
    (d / "pi.txt").write_text("0\n")
    (d / "ai.txt").write_text("0\n")
    return ["--assembly", str(d / "prog.s"),
            "--processed_assembly", str(d / "prog.txt"),
            "--architecture_params", str(d / "ap.txt"),
            "--computation_bounds", str(d / "cb.txt"),
            "--primary_input", str(d / "pi.txt"),
            "--auxiliary_input", str(d / "ai.txt")]


@pytest.mark.parametrize("module,verdict", [
    ("demo_arithmetization", "R1CS satisfied: True"),
    ("demo_ram_ppzksnark", "* The verification result is: PASS")])
def test_ram_file_demos(module, verdict, tmp_path):
    mod = importlib.import_module(f"libsnark_tpu_torch.demos.{module}")
    rc, out = run(mod.main, _write_demo_inputs(tmp_path) + CPU)
    assert rc == 0, out
    assert verdict in out
    if module == "demo_arithmetization":
        assert "program answer = 0, accepted = True" in out
        assert "first unsatisfied constraint on cpu: None" in out


def test_adsnark_demo():
    from libsnark_tpu_torch.demos import demo_r1cs_ppzkadsnark
    rc, out = run(demo_r1cs_ppzkadsnark.main, ["8", "2"] + CPU)
    assert rc == 0, out
    for line in ("* Symmetric verification: PASS",
                 "* Public verification:    PASS"):
        assert line in out
    assert run(demo_r1cs_ppzkadsnark.main, ["8"] + CPU)[0] == 1


def test_gadgetlib2_tutorial():
    from libsnark_tpu_torch.examples import tutorial_gadgetlib2
    rc, out = run(tutorial_gadgetlib2.main, CPU)
    assert rc == 0
    for line in ("protoboard usage: OK", "NAND gadget: OK",
                 "r1cs_ppzksnark on cpu: OK", "tutorial complete"):
        assert line in out, line


@pytest.mark.parametrize("module,lines", [
    ("profile_routing_algorithms", ["n=2^ 5  benes[9 cols]"]),
    ("profile_routing_gadgets", [
        "benes n=32: 848 constraints, satisfied=True, routed=True",
        "as_waksman n=32: 773 constraints, satisfied=True, routed=True"])])
def test_routing_profiles(module, lines):
    mod = importlib.import_module(f"libsnark_tpu_torch.profiles.{module}")
    rc, out = run(mod.main, ["5"])
    assert rc == 0
    for line in lines:
        assert line in out, line


@pytest.mark.parametrize("timings", [None, {}])
def test_ram_zksnark_prover_with_and_without_timings(timings, monkeypatch):
    """RamZkSnark.prover as profile_ram_zksnark calls it (no timings dict)
    and with one: a message chain and one inner proof a step (the inner
    Groth16 prover stubbed: the chain is what is checked here; the real
    proves run on the card, tests/test_torch_gpu.py)."""
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.proof_systems.ram_zksnark import (
        RamZkSnark, RamZkSnarkArchParams)
    from libsnark_tpu_torch.relations.tinyram import (Opcode, TinyRAMParams,
                                                      TinyRAMProgram)
    arch = RamZkSnarkArchParams(ap=TinyRAMParams(w=16, k=4), tree_depth=8)
    prog = TinyRAMProgram()
    prog.add(Opcode.MOV, True, 0, 0, 7)
    prog.add(Opcode.STOREW, True, 0, 0, 5)
    prog.add(Opcode.ANSWER, True, 0, 0, 0)
    rs = RamZkSnark(get_curve("bls12_377"), device="cpu")
    stubbed = []
    monkeypatch.setattr(rs.g16, "prover", lambda pk, primary, aux, seed: (
        stubbed.append(len(primary)) or f"proof {len(stubbed)}"))
    pk = types.SimpleNamespace(arch=arch, inner_pk=None)
    proof = rs.prover(pk, prog, [], 3, [], seed=2, timings=timings)
    _, msgs, _ = rs.run_and_chain(arch, prog, [], [], 3)
    assert proof.inner_proofs == ["proof 1", "proof 2", "proof 3"]
    assert proof.messages == [msgs[0], msgs[-1]]
    assert msgs[-1].has_accepted == 1
    if timings is not None:
        assert set(timings) == {"predicate_build", "witness", "inner_prove"}
