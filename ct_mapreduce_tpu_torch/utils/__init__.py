"""Shared helpers: duration parsing, the jittered backoff, synthetic
certificate builders, and a loopback CT log for tests and the card
smoke run."""

from ct_mapreduce_tpu_torch.utils.durations import (  # noqa: F401
    format_duration,
    parse_duration,
)
from ct_mapreduce_tpu_torch.utils.backoff import JitteredBackoff  # noqa: F401
