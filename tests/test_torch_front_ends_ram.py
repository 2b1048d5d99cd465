"""The port's RAM ppzkSNARK profile and split demos on the CPU.

* The RAM ppzkSNARK demo trio (TinyRAM w = 16, k = 4, time bound 4,
  boot-trace bound 8, the JAX defaults) into a temporary directory:
  generator -> prover -> verifier exit 0; the proving key read back from
  ``pk.pt`` equals the in-memory key of ``profile_ram_ppzksnark 4 8`` (the
  same seeds) tensor for tensor, and the prover demo's proof from it
  equals that profile's proof; the JAX package's ``Codec`` reads
  ``vk.txt``, ``proof.txt`` and ``boot_input.txt`` and its host
  ``RAMPpzksnark.ram_verifier`` accepts them; both packages' verifiers
  reject a changed boot input (the port's in the verifier demo, which then
  exits 1).

Keys are made on the host (``PairingSystem.host_keygen``, the same points
as the device path: tests/test_torch_ram.py) to keep CPU keygen short.
Tolerance: zero.
"""
import contextlib
import io
import shutil

import pytest

torch = pytest.importorskip("torch")

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.proof_systems.ram_ppzksnark import (
    RAMPpzksnark as JaxRAMPpzksnark)
from libsnark_tpu.serialization import Codec as JaxCodec

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.demos import (demo_ram_ppzksnark_generator,
                                      demo_ram_ppzksnark_prover,
                                      demo_ram_ppzksnark_verifier)
from libsnark_tpu_torch.profiles import profile_ram_ppzksnark
from libsnark_tpu_torch.proof_systems.base import PairingSystem
from libsnark_tpu_torch.proof_systems.bctv14 import QUERIES
from libsnark_tpu_torch.proof_systems.ram_ppzksnark import load_proving_key
from libsnark_tpu_torch.serialization import Codec

from _torch_port import coords

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


@pytest.fixture(scope="module")
def ram_demo(tmp_path_factory):
    """profile_ram_ppzksnark 4 8 (in-memory keys and proof), then the
    generator and prover demos at their defaults into one directory."""
    d = tmp_path_factory.mktemp("ram_demo")
    res = {}
    rc, out = run(profile_ram_ppzksnark.main, ["4", "8"] + CPU, result=res)
    assert rc == 0 and "verification result: PASS" in out
    rc, out = run(demo_ram_ppzksnark_generator.main, [str(d)] + CPU)
    assert rc == 0 and "pk.pt" in out
    rc, out = run(demo_ram_ppzksnark_prover.main, [str(d)] + CPU)
    assert rc == 0 and "proof.txt" in out
    return d, res


def test_ram_demo_trio(ram_demo):
    d, _ = ram_demo
    for name in ("vk.txt", "pk.pt", "program.txt", "proof.txt",
                 "boot_input.txt"):
        assert (d / name).is_file(), name
    rc, out = run(demo_ram_ppzksnark_verifier.main, [str(d)] + CPU)
    assert rc == 0 and "verification result: PASS" in out


def test_reloaded_pk_gives_the_in_memory_proof(ram_demo):
    """pk.pt read back equals the profile's in-memory key (the same
    seeds), and the prover demo's proof made from it equals the profile's
    proof made from the key in memory."""
    d, res = ram_demo
    pk, mem = load_proving_key(d / "pk.pt", "cpu"), res["keypair"].pk
    assert (pk.ap, pk.boot_trace_size_bound, pk.time_bound) == \
        (mem.ap, 8, 4)
    for q in QUERIES:
        for got, want in zip(getattr(pk.r1cs_pk, q),
                             getattr(mem.r1cs_pk, q)):
            assert got.device.type == "cpu"
            assert torch.equal(got, want), q
    dev, mdev = pk.r1cs_pk.r1cs_dev, mem.r1cs_pk.r1cs_dev
    for m in ("A", "B", "C"):
        for f in ("rows", "cols", "coeffs"):
            assert torch.equal(getattr(getattr(dev, m), f),
                               getattr(getattr(mdev, m), f)), (m, f)
    assert (dev.num_constraints, dev.num_inputs, dev.num_variables) == \
        (mdev.num_constraints, mdev.num_inputs, mdev.num_variables)
    c = Codec(get_curve("alt_bn128"))
    with open(d / "proof.txt", "rb") as f:
        assert coords(c.read_bctv14_proof(f)) == coords(res["proof"])
    with open(d / "boot_input.txt", "rb") as f:
        assert c.read_fr_vector(f) == res["boot_input"]


def test_jax_package_reads_and_verifies_the_demo_files(ram_demo, tmp_path):
    """The JAX package's Codec and host verifier accept the port's files;
    both packages reject a changed boot input, and so does the verifier
    demo (exit code 1)."""
    d, _ = ram_demo
    jc = jax_get_curve("alt_bn128")
    jcodec = JaxCodec(jc)
    with open(d / "vk.txt", "rb") as f:
        jvk = jcodec.read_bctv14_vk(f)
    with open(d / "proof.txt", "rb") as f:
        jproof = jcodec.read_bctv14_proof(f)
    with open(d / "boot_input.txt", "rb") as f:
        boot = jcodec.read_fr_vector(f)
    jrs = JaxRAMPpzksnark(jc)
    assert jrs.ram_verifier(jvk, boot, jproof)
    bad = list(boot)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % jc.r
    assert not jrs.ram_verifier(jvk, bad, jproof)
    bad_dir = tmp_path / "bad"
    shutil.copytree(d, bad_dir)
    c = Codec(get_curve("alt_bn128"))
    with open(bad_dir / "boot_input.txt", "wb") as f:
        c.write_fr_vector(f, bad)
    rc, out = run(demo_ram_ppzksnark_verifier.main, [str(bad_dir)] + CPU)
    assert rc == 1 and "verification result: FAIL" in out
