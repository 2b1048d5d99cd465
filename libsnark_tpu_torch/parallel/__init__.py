"""Multi-device proving over ``torch.distributed`` (the port of
libsnark_tpu/parallel/): the point-sharded MSM (``msm_sharded``) and the
four-step NTT domains (``ntt_sharded``) that ``Groth16.prover_sharded``
runs on."""
