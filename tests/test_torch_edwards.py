"""The port over the reference's edwards curve (its internal Weierstrass
form: 12-limb Fq and Fr, a != 0, G2 over Fq3 with beta = 61) against the
JAX package and the host oracle, bit for bit: the tests of
tests/_torch_generic_a.py, and to_affine's batched inversion on the a = 0
curves (alt_bn128, BLS12-377, BW6-761) against the JAX to_affine."""
import pytest

from libsnark_tpu import get_curve as jax_get_curve
from libsnark_tpu.ops.ec import CurveKernel as JaxCurve
from libsnark_tpu.ops.fp import FpKernel as JaxFp
from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2

from libsnark_tpu_torch import get_curve
from libsnark_tpu_torch.proof_systems.groth16 import Groth16

from _torch_generic_a import *  # noqa: F401,F403 (the shared tests)
from _torch_generic_a import to_affine_case


@pytest.fixture(scope="module", params=["edwards"])
def name(request):
    return request.param


@pytest.mark.parametrize("group", ["G1", "G2"])
@pytest.mark.parametrize("curve_name", ["alt_bn128", "bls12_377", "bw6_761"])
def test_batched_to_affine_matches_jax_on_a0_curves(curve_name, group):
    """The product tree and one Fermat inversion of the root give the JAX
    package's affine limbs on the a = 0 curves too (G2 over Fq2, or over
    Fq for BW6-761), infinity lanes planted."""
    jc, tc = jax_get_curve(curve_name), get_curve(curve_name)
    ps = Groth16(tc, device="cpu")
    jfq = JaxFp(jc.fq_params)
    if group == "G1" or ps.fq2 is None:
        jfk = jfq
    else:
        jfk = JaxFp2(jfq, int(jc.Fq2.NON_RESIDUE))
    tck = ps.g1 if group == "G1" else ps.g2
    to_affine_case(JaxCurve(jfk, group), tck, getattr(tc, group), tc.r, 61)
