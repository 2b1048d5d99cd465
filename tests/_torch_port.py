"""Helpers shared by the port's proof-system tests (tests/test_torch_*.py):
host points as integer coordinates, and comparisons of the port's keys and
proofs with the JAX package's, bit for bit."""
import dataclasses

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
    if hasattr(x.x, "c0"):
        return ((int(x.x.c0), int(x.x.c1)), (int(x.y.c0), int(x.y.c1)))
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
