"""The port over MNT4-298 and MNT6-298, the reference's PCD cycle (19-limb
Fq and Fr, a = 2 and a = 11; G2 over Fq2 with beta = 17 and over Fq3 with
beta = 5), against the JAX package and the host oracle, bit for bit: the
tests of tests/_torch_generic_a.py for each of the two curves, and MNT4's
Fq2 conjugate."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libsnark_tpu_torch.ops.limbs import from_torch

from _torch_generic_a import *  # noqa: F401,F403 (the shared tests)
from _torch_generic_a import system as _system  # noqa: F401


@pytest.fixture(scope="module", params=["mnt4", "mnt6"])
def name(request):
    return request.param


def test_mnt4_fq2_conjugate_matches_jax():
    """The one Fp2 operation of MNT4's tower that its twist's group law
    does not reach (its Frobenius and pairing use it)."""
    import random
    from libsnark_tpu import get_curve as jax_get_curve
    from libsnark_tpu.ops.fp import FpKernel as JaxFp
    from libsnark_tpu.ops.fp2 import Fp2Kernel as JaxFp2
    from libsnark_tpu_torch import get_curve
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.ops.fp2 import Fp2Kernel
    jc, tc = jax_get_curve("mnt4"), get_curve("mnt4")
    jf2 = JaxFp2(JaxFp(jc.fq_params), 17)
    tf2 = Fp2Kernel(FpKernel(tc.fq_params, device="cpu"), 17)
    rng = random.Random(7)
    els = [tc.Fq2(rng.randrange(tc.q), rng.randrange(tc.q))
           for _ in range(8)] + [tc.Fq2.zero(), tc.Fq2.one()]
    a = tf2.encode(els, device="cpu")
    want = jax.jit(jf2.conjugate)(jnp.asarray(from_torch(a)))
    got = tf2.conjugate(a)
    np.testing.assert_array_equal(from_torch(got), np.asarray(want))
    assert [tc.Fq2(*c) for c in zip(*tf2.decode(got))] == [
        tc.Fq2(x.c0, -x.c1) for x in els]
