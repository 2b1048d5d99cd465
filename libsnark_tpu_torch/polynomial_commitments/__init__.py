"""Polynomial commitments: KZG10, batched two-point KZG10 openings and
BDFG21 multi-point openings (the port of
libsnark_tpu/polynomial_commitments/)."""
