"""libsnark_tpu_torch: the PyTorch/CUDA port of libsnark_tpu.

The same layers as the JAX package, run on one NVIDIA Hopper card:

  fields / curves     host-side oracle math + pairings (verifier path)
  ops                 batched field, curve, MSM and NTT code over limb
                      tensors; hand-written CUDA kernels under csrc/
  relations           R1CS (host authoring + device COO mat-vec), USCS,
                      BACS, TBCS, QAP / SAP / SSP checks, example circuits
  common              sparse / accumulation vectors, knowledge commitments
  reductions          r1cs -> qap (with the ZK patch), r1cs -> sap,
                      uscs -> ssp, bacs -> r1cs, tbcs -> uscs
  proof_systems       Groth16 over alt_bn128 and BLS12-377; BCTV14, GM17,
                      DFGK14, BACS and TBCS
  polynomial_commitments  KZG10, batched KZG, BDFG21
  profiling           nested phase timers that synchronise the device

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from .curves import get_curve, available_curves  # noqa: F401
