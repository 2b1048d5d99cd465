"""Helpers shared by the port's proof-system tests (tests/test_torch_*.py):
host points as integer coordinates, and comparisons of the port's keys and
proofs with the JAX package's, bit for bit."""
import dataclasses
import operator

import numpy as np

from libsnark_tpu_torch.ops.limbs import from_torch


def coords(x):
    """Points (G1, G2, knowledge commitments, accumulation vectors, lists
    and dataclasses of them) as plain integer coordinates; infinity is
    None."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [coords(v) for v in x]
    if hasattr(x, "first") and hasattr(x, "rest"):      # AccumulationVector
        return (coords(x.first), list(x.rest.indices), coords(x.rest.values),
                x.rest.domain_size())
    if hasattr(x, "g") and hasattr(x, "h"):              # KnowledgeCommitment
        return (coords(x.g), coords(x.h))
    if dataclasses.is_dataclass(x):
        return {f.name: coords(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if x.is_zero():
        return None
    if hasattr(x.x, "c0"):                  # over Fq2 or Fq3
        cs = ("c0", "c1", "c2") if hasattr(x.x, "c2") else ("c0", "c1")
        return tuple(tuple(int(getattr(v, c)) for c in cs)
                     for v in (x.x, x.y))
    return (int(x.x), int(x.y))


def assert_matrix_equal(m, jm, name):
    np.testing.assert_array_equal(m.rows.cpu().numpy(), np.asarray(jm.rows),
                                  err_msg=name)
    np.testing.assert_array_equal(m.cols.cpu().numpy(), np.asarray(jm.cols),
                                  err_msg=name)
    np.testing.assert_array_equal(from_torch(m.coeffs), np.asarray(jm.coeffs),
                                  err_msg=name)
    assert (m.num_rows, m.num_cols) == (jm.num_rows, jm.num_cols), name


def assert_keys_equal(kp, jkp, queries, device_field, matrices):
    """Every query's (x, y, inf) limbs, every host point of the proving and
    verification keys, and the device matrices equal the JAX key's."""
    pk, jpk = kp.pk, jkp.pk
    for q in queries:
        for got, want in zip(getattr(pk, q), getattr(jpk, q)):
            np.testing.assert_array_equal(from_torch(got), np.asarray(want),
                                          err_msg=q)
    for f in dataclasses.fields(pk):
        if f.name not in queries and f.name != device_field:
            assert coords(getattr(pk, f.name)) == \
                coords(getattr(jpk, f.name)), f.name
    dev, jdev = getattr(pk, device_field), getattr(jpk, device_field)
    for name in matrices:
        assert_matrix_equal(getattr(dev, name), getattr(jdev, name), name)
    assert coords(kp.vk) == coords(jkp.vk)


def numpy_queries(jpk, names):
    return {q: tuple(np.asarray(a) for a in getattr(jpk, q)) for q in names}


def numpy_matrices(jdev, names):
    return {n: (getattr(jdev, n).rows, getattr(jdev, n).cols,
                getattr(jdev, n).coeffs) for n in names}


def trapdoor_groth16(curve, cs, primary, aux, seed=99):
    """(vk, proof) of the port's Groth16 made on the host from the
    trusted-setup trapdoor: a valid proof without the prover (the port's
    copy of tests/test_verifier_gadget.py::_trapdoor_groth16, on the
    port's QAP code)."""
    import random
    from libsnark_tpu_torch.ops.fp import FpKernel
    from libsnark_tpu_torch.proof_systems.groth16 import (
        Groth16Proof, Groth16VerificationKey)
    from libsnark_tpu_torch.reductions.r1cs_to_qap import (
        qap_domain, qap_instance_map_with_evaluation)
    rng = random.Random(seed)
    r = curve.r
    t, alpha, beta, gamma, delta, rr, ss = (
        rng.randrange(1, r) for _ in range(7))
    fr = FpKernel(curve.fr_params, "cpu")
    domain = qap_domain(fr, curve.fr_params, cs)
    qap = qap_instance_map_with_evaluation(cs, domain, t)
    full = [1] + [v % r for v in primary] + [v % r for v in aux]
    k = cs.num_inputs
    A_e = (alpha + sum(s * a for s, a in zip(full, qap.At)) + rr * delta) % r
    B_e = (beta + sum(s * b for s, b in zip(full, qap.Bt)) + ss * delta) % r
    pub_e = sum(full[i] * (beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
                for i in range(k + 1)) % r
    C_e = (A_e * B_e - alpha * beta - pub_e) * pow(delta, -1, r) % r
    G1, G2 = curve.G1.one(), curve.G2.one()
    gamma_inv = pow(gamma, -1, r)
    vk = Groth16VerificationKey(
        alpha_g1=G1 * alpha, beta_g2=G2 * beta, gamma_g2=G2 * gamma,
        delta_g2=G2 * delta,
        gamma_ABC=[G1 * ((beta * qap.At[i] + alpha * qap.Bt[i] + qap.Ct[i])
                         * gamma_inv % r) for i in range(k + 1)])
    proof = Groth16Proof(g_A=G1 * A_e, g_B=G2 * B_e, g_C=G1 * C_e)
    return vk, proof


def dummy_vk(curve, statement, seed=7):
    """tests/test_pcd_cycle.py's _dummy_vk on the port: a trapdoor (vk,
    proof) under a one-input always-satisfiable system, statement as its
    input (the same seed gives the same vk)."""
    from libsnark_tpu_torch.relations.r1cs import R1CSConstraintSystem
    from libsnark_tpu_torch.relations.variable import Variable
    cs = R1CSConstraintSystem(curve.r, 1, 1)
    w = Variable(2)
    cs.add_constraint(w * 1, w * 1, w * 1, "w_bool")
    return trapdoor_groth16(curve, cs, [statement % curve.r], [0],
                            seed=seed)


def host_point(curve, group, xy):
    """coords' inverse for one point of ``group`` (curve.G1 or curve.G2)
    of either package's curve."""
    if xy is None:
        return group.zero()
    if isinstance(xy[0], tuple):
        F = curve.Fq2 if len(xy[0]) == 2 else curve.Fq3
        return group.point(F(*xy[0]), F(*xy[1]))
    return group.point(*xy)


def carry_vk(jcurve, vk):
    """The port's Groth16 verification key as the JAX package's, through
    plain integer coordinates."""
    from libsnark_tpu.proof_systems.groth16 import (
        Groth16VerificationKey as JaxVK)
    G1, G2 = jcurve.G1, jcurve.G2
    return JaxVK(
        alpha_g1=host_point(jcurve, G1, coords(vk.alpha_g1)),
        beta_g2=host_point(jcurve, G2, coords(vk.beta_g2)),
        gamma_g2=host_point(jcurve, G2, coords(vk.gamma_g2)),
        delta_g2=host_point(jcurve, G2, coords(vk.delta_g2)),
        gamma_ABC=[host_point(jcurve, G1, coords(P)) for P in vk.gamma_ABC])


def carry_vk_and_proof(jcurve, vk, proof):
    """The port's Groth16 (vk, proof) as the JAX package's."""
    from libsnark_tpu.proof_systems.groth16 import Groth16Proof as JaxProof
    G1, G2 = jcurve.G1, jcurve.G2
    jproof = JaxProof(g_A=host_point(jcurve, G1, coords(proof.g_A)),
                      g_B=host_point(jcurve, G2, coords(proof.g_B)),
                      g_C=host_point(jcurve, G1, coords(proof.g_C)))
    return carry_vk(jcurve, vk), jproof


def plain(x):
    """Dataclasses (traces, instructions, parameters, messages), lists and
    dicts as tuples of ints: the IntEnums of both packages compare as
    ints."""
    if dataclasses.is_dataclass(x):
        return tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple((plain(k), plain(v)) for k, v in x.items())
    return int(x) if isinstance(x, int) else x


def r1cs_terms(pb):
    """A protoboard's constraints as plain integers: ((index, coeff) terms
    of a, b and c, annotation) each."""
    return [tuple(tuple((t.index, t.coeff) for t in lc.terms)
                  for lc in (a, b, c)) + (ann,)
            for a, b, c, ann in pb.constraints]


def board(pb):
    """Everything of a protoboard as plain integers and strings: the
    constraints (r1cs_terms), the variable values (the witness), the
    annotations and the input size."""
    return (r1cs_terms(pb), list(pb._values), list(pb._annotations),
            pb.num_inputs)


def _index_coeff(lc):
    return (list(map(operator.attrgetter("index"), lc.terms)),
            list(map(operator.attrgetter("coeff"), lc.terms)))


def assert_same_board(pb, jpb):
    """Constraint for constraint: the (index, coeff) terms of a, b and c
    in order and the annotation; then the values and the variable
    annotations, and the input size. Streamed: an aggregation circuit
    holds ~5.5e7 terms."""
    assert pb.num_constraints == jpb.num_constraints
    for i, (con, jcon) in enumerate(zip(pb.constraints, jpb.constraints)):
        assert con[3] == jcon[3], i
        for lc, jlc in zip(con[:3], jcon[:3]):
            assert _index_coeff(lc) == _index_coeff(jlc), (i, con[3])
    assert pb._values == jpb._values
    assert pb._annotations == jpb._annotations
    assert pb.num_inputs == jpb.num_inputs
