"""Host polynomial helpers for the polynomial-commitment layer (the port's
own copy of libsnark_tpu/polynomial_commitments/polynomial_ops.py;
reference libfqfft polynomial basic_operations + kzg10_batched.tcc
internal namespace). Coefficient lists of python ints mod r."""
from __future__ import annotations

from typing import List


def poly_eval(coeffs: List[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc


def poly_scalar_mul(coeffs: List[int], k: int, r: int) -> List[int]:
    return [c * k % r for c in coeffs]


def poly_add(a: List[int], b: List[int], r: int) -> List[int]:
    n = max(len(a), len(b))
    out = [0] * n
    for i, c in enumerate(a):
        out[i] = c % r
    for i, c in enumerate(b):
        out[i] = (out[i] + c) % r
    return out


def poly_sub(a: List[int], b: List[int], r: int) -> List[int]:
    return poly_add(a, [(-c) % r for c in b], r)


def poly_accumulate_with_power_factors(polys, factor: int, r: int):
    """sum_i factor^i * polys[i] via Horner (kzg10_batched.tcc:67-91)."""
    t = len(polys)
    if t == 1:
        return [c % r for c in polys[0]]
    acc = poly_scalar_mul(polys[t - 1], factor, r)
    acc = poly_add(acc, polys[t - 2], r)
    for i in range(t - 3, -1, -1):
        acc = poly_scalar_mul(acc, factor, r)
        acc = poly_add(acc, polys[i], r)
    return acc


def poly_divide_by_linear(coeffs: List[int], z: int, r: int):
    """(quotient, remainder) of coeffs / (X - z): synthetic division.

    q[n-2] = c[n-1]; q[i-1] = c[i] + z*q[i]; rem = c[0] + z*q[0].
    """
    n = len(coeffs)
    if n == 0:
        return [], 0
    if n == 1:
        return [], coeffs[0] % r
    q = [0] * (n - 1)
    q[n - 2] = coeffs[n - 1] % r
    for i in range(n - 2, 0, -1):
        q[i - 1] = (coeffs[i] + z * q[i]) % r
    rem = (coeffs[0] + z * q[0]) % r
    return q, rem
