"""Dirty-group tracking for incremental ``CTMRFL02`` builds: opaque
per-group content tokens plus the prior-epoch group cache (a copy of
``ct_mapreduce_tpu.filter.cache``, which imports nothing of JAX).

The per-group-universe format (docs/FILTER_FORMAT.md, CTMRFL02) makes
a group's serialized block a pure function of its OWN serial set and
the target FP rate — no other group's churn can move its bytes. That
is what makes verbatim reuse sound: if a group's content token is
unchanged since the previous build, the previous build's
:class:`~ct_mapreduce_tpu_torch.filter.artifact.FilterGroup`
(cascade arrays included) serializes to identical block bytes, so the builder skips
key generation and the layer scatter for it entirely. Epoch-tick build
cost becomes O(churn), not O(corpus).

Tokens are OPAQUE to the cache: the only contract is that a group's
token changes whenever its serial set changes (a stale-token false
MISS costs a redundant rebuild — always safe; a false HIT would be a
correctness bug, which is why the capture layer only reports exact
hashes, see :meth:`SpillCaptureRing.content_hashes`). Two token
producers exist:

- :func:`content_token` — ``(n, XOR of sha256(serial)[:16])`` over a
  deduplicated serial set. XOR is commutative/associative, so the
  capture layer maintains it incrementally per new serial and a
  recomputation from the set agrees exactly. XOR of per-subset hashes
  is NOT a union hash (shared serials cancel) — fleet merges must
  recompute from the union set, never combine worker hashes.
- Analytic tokens (benches): any value that is a pure function of the
  group's logical content qualifies — ``tools/filtercost.py`` derives
  tokens from its synthetic corpus parameters without hashing.

Reuse is an optimization, never a semantic: the rebuilt artifact's
bytes are pinned identical to a from-scratch build by
tests/test_filter_format.py.

Deterministic throughout — no wall-clock, no RNG, no unsorted
iteration reaches any byte-producing path (ctmrlint: determinism).
"""

from __future__ import annotations

import hashlib
from typing import Optional


def serial_hash(serial: bytes) -> int:
    """One serial's 128-bit content hash (low 16 bytes of SHA-256),
    as an int so set hashes XOR-combine without numpy overflow."""
    return int.from_bytes(hashlib.sha256(serial).digest()[:16], "big")


def content_token(serials) -> tuple[int, int]:
    """``(n, xor-of-serial-hashes)`` over a DEDUPLICATED serial
    iterable (a set, or any iterable without repeats — a repeated
    serial would XOR-cancel). Pure function of the serial set."""
    h = 0
    n = 0
    for s in serials:
        h ^= serial_hash(s)
        n += 1
    return (n, h)


class GroupBuildCache:
    """Prior-epoch ``(issuer, expHour) → (token, fp_rate, group)``
    store for the CTMRFL02 incremental build path. ``get`` returns the
    cached :class:`FilterGroup` only on an exact (token, fp_rate)
    match; ``put`` records the groups a build produced; ``prune``
    drops groups absent from the current epoch so removed groups
    cannot resurrect from a stale entry."""

    def __init__(self) -> None:
        self._groups: dict = {}
        # Cumulative reuse accounting across builds (tests/tools).
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._groups)

    def get(self, issuer: str, exp_hour: int, token,
            fp_rate: float) -> Optional[object]:
        if token is None:
            self.misses += 1
            return None
        ent = self._groups.get((issuer, int(exp_hour)))
        if ent is None or ent[0] != token or ent[1] != float(fp_rate):
            self.misses += 1
            return None
        self.hits += 1
        return ent[2]

    def put(self, issuer: str, exp_hour: int, token,
            fp_rate: float, group) -> None:
        if token is None:
            return
        self._groups[(issuer, int(exp_hour))] = (
            token, float(fp_rate), group)

    def prune(self, live_keys) -> None:
        """Drop entries whose (issuer, expHour) is not in
        ``live_keys`` (the current build's group set)."""
        live = set(live_keys)
        for key in sorted(self._groups):
            if key not in live:
                del self._groups[key]
