"""Layered configuration (copy of the directives the port reads)."""

from ct_mapreduce_tpu_torch.config.config import CTConfig  # noqa: F401
