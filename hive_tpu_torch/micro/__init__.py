"""Measurement entry points: the ports of the JAX package's kernel
micro-experiments (``scripts/micro_pallas_gather.py``,
``scripts/micro_pallas_fused_band.py``), each run as
``python -m hive_tpu_torch.micro.<name> [--device cpu]``."""
