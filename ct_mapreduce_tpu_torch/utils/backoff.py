"""Jittered exponential backoff for HTTP 429 handling.

Mirrors the reference's use of jpillora/backoff with Min=500ms,
Max=5min, jitter on (reference cmd/ct-fetch/ct-fetch.go:409-413).

A copy of ``ct_mapreduce_tpu.utils.backoff``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import random


class JitteredBackoff:
    def __init__(
        self,
        min_s: float = 0.5,
        max_s: float = 300.0,
        factor: float = 2.0,
        jitter: bool = True,
    ):
        self.min_s = min_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = jitter
        self.attempt = 0

    def duration(self) -> float:
        """Next backoff delay in seconds; advances the attempt counter."""
        d = min(self.max_s, self.min_s * (self.factor**self.attempt))
        self.attempt += 1
        if self.jitter:
            d = random.uniform(self.min_s, d) if d > self.min_s else d
        return d

    def reset(self) -> None:
        self.attempt = 0
