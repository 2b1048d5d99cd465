"""The plain versions of the port's two probe kernels (libsnark_tpu_torch/
probes.py) against Python integer arithmetic, exactly. The kernels are held
against these plain versions on the card (tests/test_torch_gpu.py,
scripts/probe_h100.py, chip_smoke.py); on CPU tensors the wrappers run the
plain versions.
"""
import random
import struct

import pytest
import torch

from libsnark_tpu_torch import get_curve, probes
from libsnark_tpu_torch.ops.fp import FpKernel

M32 = 0xFFFFFFFF


def _step(op, x, hi, y):
    """One step of a chain on Python ints (x, hi: the 64-bit ops' halves)."""
    if op == "mul_lo":
        return (x * y) & M32, 0
    if op == "mad_lo":
        return (x * y + y) & M32, 0
    if op == "mad_hi":
        return (((x * y) >> 32) + y) & M32, 0
    if op == "mad_wide":
        w = (x * y + ((hi << 32) | x)) & ((1 << 64) - 1)   # w = lo(w)*y + w
        return w & M32, w >> 32
    if op == "add64":
        w = (((hi << 32) | x) + ((y << 32) | y)) & ((1 << 64) - 1)
        return w & M32, w >> 32
    if op == "shift_and":
        return ((x >> 1) & y) ^ y, 0
    raise AssertionError(op)


def _bits(v):
    return v - (1 << 32) if v >= 1 << 31 else v


@pytest.mark.parametrize("op", [o for o in probes.RATE_OPS if o != "mul_f32"])
def test_rate_chain_plain_matches_python_ints(op):
    rng = random.Random(1)
    T, K = 5, 9
    edge = [0, 1, M32, 1 << 31, 0xFFFF0001]
    xs = [[rng.choice(edge + [rng.getrandbits(32)]) for _ in range(T)]
          for _ in range(probes.CHAINS)]
    ys = [[rng.choice(edge + [rng.getrandbits(32)]) for _ in range(T)]
          for _ in range(probes.CHAINS)]
    want = []
    for xr, yr in zip(xs, ys):
        row = []
        for x, y in zip(xr, yr):
            hi = 0
            for _ in range(K):
                x, hi = _step(op, x, hi, y)
            row.append(_bits(x ^ hi if op in ("mad_wide", "add64") else x))
        want.append(row)
    a = torch.tensor([[_bits(v) for v in r] for r in xs], dtype=torch.int32)
    b = torch.tensor([[_bits(v) for v in r] for r in ys], dtype=torch.int32)
    got = probes.rate_chain(op, a, b, K)          # CPU tensors: plain version
    assert got.dtype == torch.int32
    assert got.tolist() == want


def test_rate_chain_f32_is_a_plain_product_chain():
    a = torch.full((probes.CHAINS, 3), 1.25)
    b = torch.full((probes.CHAINS, 3), 1.0 + 2.0 ** -12)
    got = probes.rate_chain("mul_f32", a, b, 5)
    x = 1.25
    for _ in range(5):
        x = struct.unpack("f", struct.pack("f", x * (1.0 + 2.0 ** -12)))[0]
    assert got.dtype == torch.float32 and float(got[0, 0]) == x


@pytest.mark.parametrize("curve_name,field", [("alt_bn128", "fq"),
                                              ("bls12_377", "fq")])
def test_cios_chain_plain_matches_python_ints(curve_name, field):
    curve = get_curve(curve_name)
    fk = FpKernel(getattr(curve, f"{field}_params"), device="cpu")
    rng = random.Random(2)
    xs = [0, 1, fk.p - 1] + [rng.randrange(fk.p) for _ in range(5)]
    ys = [rng.randrange(fk.p) for _ in range(8)]
    K = 3
    a, b = fk.encode(xs, mont=False), fk.encode(ys, mont=False)
    rinv = pow(fk.params.R, -1, fk.p)
    want = [x * pow(y * rinv, K, fk.p) % fk.p for x, y in zip(xs, ys)]
    for variant in probes.CIOS_VARIANTS:          # CPU: one plain version
        got = probes.cios_chain(fk, variant, a, b, K)
        assert fk.decode(got, mont=False) == want


def test_probe_wrappers_check_their_arguments():
    fk = FpKernel(get_curve("alt_bn128").fq_params, device="cpu")
    a = torch.zeros((probes.CHAINS, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown rate op"):
        probes.rate_chain("div", a, a, 1)
    with pytest.raises(ValueError, match="takes two"):
        probes.rate_chain("mul_lo", a[:3], a[:3], 1)
    with pytest.raises(ValueError, match="takes two"):
        probes.rate_chain("mul_f32", a, a, 1)
    x = fk.encode([1, 2])
    with pytest.raises(ValueError, match="unknown CIOS variant"):
        probes.cios_chain(fk, "fios", x, x, 1)
    with pytest.raises(ValueError, match="limb tensors"):
        probes.cios_chain(fk, "cios", x[:8], x[:8], 1)


def test_main_loop_counts_the_longest_backward_branch():
    """The listing reader behind ``sass_loops``: the loop is the span of the
    longest backward branch; predicates and encodings are skipped."""
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0a */
        /*0010*/                   IMAD.WIDE.U32 R2, R2, R4, R2 ;  /* 0x0b */
        /*0020*/                   IMAD.WIDE.U32 R6, R6, R4, R6 ;
        /*0030*/                   IADD3 R9, R9, 0x1, RZ ;
        /*0040*/             @!P0  BRA 0x10 ;
        /*0050*/                   SHF.R.U32.HI R3, RZ, 0x1, R3 ;
        /*0060*/              @P1  BRA 0x50 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
    """
    assert probes.main_loop(sass) == {"IMAD.WIDE.U32": 2, "IADD3": 1, "BRA": 1}
    assert probes.main_loop("/*0000*/ EXIT ;") == {}
    assert probes._kernel_label("_Z11rate_kernelILi3EEvPKjS1_Pjli") \
        == "probe_rate_mad_wide"
    assert probes._kernel_label("_Z11cios_kernelILi12ELi1EEvPKiS1_Pili") \
        == "probe_cios_sos_n24"
