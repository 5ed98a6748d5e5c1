"""Layered configuration (a copy of the JAX package's ``CTConfig``)."""

from ct_mapreduce_tpu_torch.config.config import CTConfig  # noqa: F401
