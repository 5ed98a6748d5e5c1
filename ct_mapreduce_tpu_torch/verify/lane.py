"""The ingest-side signature-verification lane (``verifySignatures``), a
port of ``ct_mapreduce_tpu.verify.lane``.

``SignatureVerifier`` sits beside the dedup dispatch in
``AggregatorSink``: each prepared chunk's extracted SCT tuples
(:func:`ct_mapreduce_tpu_torch.native.leafpack.extract_scts`) are
classified lane by lane —

- **device P-256** — a P-256-shaped SCT (extractor status ``SCT_OK``)
  whose log key is a registered P-256 key: staged into a fixed-width
  batch for the ECDSA verify (:mod:`ct_mapreduce_tpu_torch.ops.ecdsa`:
  the CUDA kernel K6 on a CUDA aggregator, its plain PyTorch version on
  a CPU one), dispatched asynchronously on the current stream (a
  pending deque of depth 2, as the sink pipelines its dedup steps),
  read back and folded under the aggregator's fold lock.
- **device P-384** — a lane keyed to a registered P-384 log replays its
  SCT from the row bytes (the compact batch carries only 32-byte
  scalars) and, when it is a well-formed SHA-256/ECDSA signature,
  batches onto the P-384 verify the same way.
- **host** — SCT present but not device-decidable (RSA signatures,
  unregistered-curve keys, malformed DER innards): replayed through the
  pure-python reference verifier from the lane's row bytes. This is
  the JAX lane's routing, not a fallback: no device-decidable lane
  takes it.
- **no_key / no_sct** — counted, not judged.

With ``verifyPrecompWindow`` > 0 (the default 8) the device lanes run
the windowed ladder: u1·G reads the process-wide fixed-base G table and
u2·Q a per-log-key window table cached in ``verifyQTableSize``
Q-table slots on the aggregator's device, keyed on the registry entry
and its registration epoch, LRU-evicted. ``verifyPrecompWindow = 0``
runs the Jacobian ladder (no tables).

Where this port departs from the JAX module: the G table and the
Q-table slots are torch tensors on the aggregator's own device, in the
kernel's packed layout (:func:`..ops.ecdsa.pack_table`); a slot is
filled by an in-place copy. A failed build or launch of K6 raises: the
batch fails, it is never decided by the plain version.

Results land on the aggregator as per-issuer verified/failed vectors
(checkpoints, ``drain()``, storage-statistics) plus ``verify.*``
telemetry counters and ``device.verify`` spans; Q-table occupancy rides
the ``/healthz`` ``verify`` section (:meth:`SignatureVerifier.health`).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.telemetry import trace
from ct_mapreduce_tpu_torch.telemetry.metrics import (
    add_sample,
    incr_counter,
    set_gauge,
)
from ct_mapreduce_tpu_torch.verify import sct as sctlib

DEFAULT_BATCH = 1024
DEFAULT_WINDOW = 8  # keep in sync with ops.ecdsa.DEFAULT_WINDOW
VALID_WINDOWS = (0, 2, 4, 8)
DEFAULT_QTABLE = 32  # per-curve Q-table slots on the device

_VERIFY_KNOBS = (
    platprofile.Knob("verifySignatures", "CTMR_VERIFY", False,
                     parse=lambda s: s.strip() == "1",
                     env_is_set=platprofile.any_set, post=bool),
    platprofile.Knob("verifyLogKeys", "CTMR_VERIFY_KEYS", "",
                     parse=str, is_set=platprofile.nonempty_str),
    platprofile.Knob("verifyBatch", "CTMR_VERIFY_BATCH", DEFAULT_BATCH,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: int(v)),
    # -1 = unset; 0 is a REAL value (the Jacobian ladder), so an
    # explicit 0 must beat a stray env var.
    platprofile.Knob("verifyPrecompWindow", "CTMR_VERIFY_PRECOMP_WINDOW",
                     -1, parse=int, is_set=platprofile.nonneg_int),
    platprofile.Knob("verifyQTableSize", "CTMR_VERIFY_QTABLE_SIZE",
                     DEFAULT_QTABLE, parse=int,
                     is_set=platprofile.pos_int,
                     post=lambda v: int(v)),
)


def resolve_verify(flag: Optional[bool] = None,
                   keys_path: Optional[str] = None,
                   batch: int = 0,
                   window: Optional[int] = None,
                   qtable_size: int = 0,
                   ) -> tuple[bool, str, int, int, int]:
    """Resolve the verify-lane knobs through the platformProfile ladder:
    explicit value (config directive / kwarg) > ``CTMR_VERIFY`` /
    ``CTMR_VERIFY_KEYS`` / ``CTMR_VERIFY_BATCH`` /
    ``CTMR_VERIFY_PRECOMP_WINDOW`` / ``CTMR_VERIFY_QTABLE_SIZE`` env >
    profile ``knobs.verify`` > defaults (off; no key file; 1024-lane
    device batches; 8-bit windows; 32 Q-table slots). ``window = 0``
    selects the Jacobian ladder; unparseable env values are ignored."""
    r = platprofile.resolve_section("verify", _VERIFY_KNOBS, {
        "verifySignatures": flag,
        "verifyLogKeys": keys_path or "",
        "verifyBatch": int(batch or 0),
        "verifyPrecompWindow": (-1 if window is None else int(window)),
        "verifyQTableSize": int(qtable_size or 0),
    })
    w = int(r["verifyPrecompWindow"])
    if w < 0 or w not in VALID_WINDOWS:
        w = DEFAULT_WINDOW if w != 0 else 0
    return (r["verifySignatures"], r["verifyLogKeys"],
            r["verifyBatch"], w, r["verifyQTableSize"])


class LogKeyRegistry:
    """log_id (32 bytes) → key entry dict, the trust anchors of the
    verify lane. Entries are the JSON shape the fixture signers emit
    (:meth:`~ct_mapreduce_tpu_torch.verify.sct.EcSctSigner.key_entry`):
    ``{"log_id": hex, "alg": "p256"|"p384"|"rsa", ...}``; the files are
    the JAX package's. Every registration stamps the entry with a
    monotonically increasing registry epoch (``_epoch``) — the Q-table
    cache keys on it, so re-registering a log id invalidates exactly
    that key's cached table."""

    def __init__(self) -> None:
        self._keys: dict[bytes, dict] = {}
        self._lock = threading.Lock()
        self._epoch = 0

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def epoch(self) -> int:
        return self._epoch

    def register(self, entry: dict) -> None:
        with self._lock:
            e = dict(entry)
            self._epoch += 1
            e["_epoch"] = self._epoch
            self._keys[bytes.fromhex(entry["log_id"])] = e

    def register_signer(self, signer) -> None:
        self.register(signer.key_entry())

    def get(self, log_id: bytes) -> Optional[dict]:
        return self._keys.get(log_id)

    def is_p256(self, log_id: bytes) -> bool:
        e = self._keys.get(log_id)
        return e is not None and e.get("alg") == "p256"

    def to_json(self) -> str:
        with self._lock:
            entries = [
                {k: v for k, v in e.items() if not k.startswith("_")}
                for e in self._keys.values()
            ]  # "_"-prefixed keys are runtime caches (coordinates, epoch)
            return json.dumps(sorted(entries, key=lambda e: e["log_id"]))

    def entries(self) -> list[dict]:
        """Snapshot of the registered entries (runtime fields included),
        sorted by log id — what the Q-table prebuild walks."""
        with self._lock:
            return [self._keys[k] for k in sorted(self._keys)]

    @classmethod
    def from_json_file(cls, path: str) -> "LogKeyRegistry":
        reg = cls()
        with open(path) as fh:
            for entry in json.load(fh):
                reg.register(entry)
        return reg


class _PendingVerify:
    """One dispatched device verify batch awaiting readback."""

    def __init__(self, out: torch.Tensor, n: int,
                 issuer_idx: np.ndarray) -> None:
        self.out = out  # bool[width] on the aggregator's device
        self.n = n
        self.issuer_idx = issuer_idx  # int64[n]


class _CurveLane:
    """Per-curve staging state: the staging buffer, the fixed-base G
    table and the Q-table slots (both on the aggregator's device)."""

    def __init__(self, ops, window: int, slots: int) -> None:
        self.ops = ops
        self.window = window
        self.capacity = max(1, int(slots))
        self.buf: list[tuple] = []  # (digest, r, s, qx, qy, iidx, tabkey)
        self.slot_of: "OrderedDict[tuple, int]" = OrderedDict()  # LRU
        self.gtab: Optional[torch.Tensor] = None  # [nwin, 2^w, 2, nl/2]
        self.qtab: Optional[torch.Tensor] = None  # [slots, nwin, 2^w, 2, nl/2]

    def occupancy(self) -> int:
        return len(self.slot_of)


class SignatureVerifier:
    """Batches device-eligible SCT lanes across chunks and folds verdicts
    into the aggregator. Every entry point is called under the sink's
    dispatch lock (one device stream), so internal state needs no lock
    of its own; folds take the aggregator's fold lock."""

    def __init__(self, agg, keys: Optional[LogKeyRegistry] = None,
                 batch_width: int = DEFAULT_BATCH, depth: int = 2,
                 window: Optional[int] = None,
                 qtable_size: int = 0) -> None:
        self.agg = agg
        self.device = agg.device
        self.keys = keys if keys is not None else LogKeyRegistry()
        self.batch_width = max(16, int(batch_width))
        self.depth = max(0, int(depth))
        _, _, _, self.window, self.qtable_size = resolve_verify(
            True, "x", 1, window, qtable_size)
        self._lanes: dict[str, _CurveLane] = {}  # curve name → staging
        self._inflight: deque[_PendingVerify] = deque()
        set_gauge("verify", "precomp_window", value=float(self.window))
        # Scalar outcomes (also exported as verify.* counters; kept here
        # so tests and the smoke run can read exact totals).
        self.stats = {
            "device_lanes": 0, "host_lanes": 0, "no_sct": 0,
            "no_key": 0, "verified": 0, "failed": 0, "batches": 0,
            "p384_lanes": 0, "qtable_hits": 0, "qtable_misses": 0,
        }
        # Warm the host-side window table of every registered key on a
        # background thread, so the first dispatch under a key finds it
        # in the process-wide cache (point_table_cached is lock-guarded
        # and keyed on coordinates; a racing dispatch at worst builds it
        # first and the prebuild's call becomes a hit).
        self._prebuild_thread = None
        if self.window > 0 and len(self.keys):
            self._prebuild_thread = threading.Thread(
                target=self._prebuild_qtables,
                name="verify-qtable-prebuild", daemon=True)
            self._prebuild_thread.start()

    def _prebuild_qtables(self) -> None:
        from ct_mapreduce_tpu_torch.ops import ecdsa

        for e in self.keys.entries():
            alg = e.get("alg")
            if alg not in ecdsa.CURVE_OPS:
                continue
            try:
                _, build_s = ecdsa.point_table_cached(
                    ecdsa.CURVE_OPS[alg], self.window,
                    int(e["x"], 16), int(e["y"], 16))
            except (KeyError, ValueError):
                continue  # malformed entry: the dispatch path reports
            if build_s > 0.0:
                add_sample("verify", "qtable_build_s", value=build_s)
                incr_counter("verify", "qtable_prebuilt")

    # -- classification + staging ---------------------------------------
    def submit_chunk(self, scts: sctlib.SctBatch, issuer_idx: np.ndarray,
                     eligible: np.ndarray, rows: np.ndarray,
                     lengths: np.ndarray) -> None:
        """Route one prepared chunk's SCT lanes. ``eligible`` marks lanes
        that decoded OK with a mapped issuer (filtered and duplicate
        lanes still carry auditable SCTs)."""
        eligible = np.asarray(eligible, bool)
        ok = scts.ok
        no_sct = int((eligible & (ok == sctlib.SCT_NONE)).sum())
        if no_sct:
            self.stats["no_sct"] += no_sct
            incr_counter("verify", "no_sct", value=float(no_sct))
        lanes = np.nonzero(eligible & (ok != sctlib.SCT_NONE))[0]
        host_lanes: list[int] = []
        for i in lanes:
            i = int(i)
            log_id = scts.log_id[i].tobytes()
            key = self.keys.get(log_id)
            if key is None:
                self.stats["no_key"] += 1
                incr_counter("verify", "no_key")
                continue
            alg = key.get("alg")
            if ok[i] == sctlib.SCT_OK and alg == "p256":
                self._lane("p256").buf.append((
                    scts.digest[i], scts.r[i], scts.s[i],
                    _key_coord(key, "x"), _key_coord(key, "y"),
                    int(issuer_idx[i]), _table_key(log_id, key),
                ))
            elif alg == "p384" and not self._stage_p384(
                    i, log_id, key, scts, issuer_idx, rows, lengths):
                host_lanes.append(i)
            elif alg not in ("p256", "p384"):
                host_lanes.append(i)
            elif alg == "p256":  # SCT_FALLBACK under a p256 key
                host_lanes.append(i)
        if host_lanes:
            self._host_verify(host_lanes, scts, issuer_idx, rows, lengths)
        for lane in self._lanes.values():
            while len(lane.buf) >= self.batch_width:
                self._dispatch(lane, self.batch_width)
        self._drain_inflight(self.depth)

    def _stage_p384(self, i: int, log_id: bytes, key: dict, scts,
                    issuer_idx, rows, lengths) -> bool:
        """Re-extract lane ``i``'s SCT from its row bytes and stage it
        for the P-384 verify when it is device-decidable: exactly the
        preconditions :func:`~ct_mapreduce_tpu_torch.verify.sct.
        host_verify_sct` applies before its P-384 curve math. Returns
        False (→ the host lane, which fails it closed) otherwise."""
        der = rows[i, : int(lengths[i])].tobytes()
        _status, sc, _digest, _r, _s = sctlib.extract_sct_lane(der)
        if (sc is None or sc.version != 0
                or sc.hash_alg != sctlib.HASH_SHA256
                or sc.sig_alg != sctlib.SIG_ECDSA):
            return False
        rs = sctlib.parse_ecdsa_sig(sc.signature, 48)
        if rs is None:
            return False
        dg = np.zeros((48,), np.uint8)
        # The batch digest, not the re-extracted one: only the batch
        # carries the lane's issuer_key_hash.
        dg[16:] = scts.digest[i]
        self._lane("p384").buf.append((
            dg,
            np.frombuffer(rs[0].to_bytes(48, "big"), np.uint8),
            np.frombuffer(rs[1].to_bytes(48, "big"), np.uint8),
            _key_coord(key, "x", 48), _key_coord(key, "y", 48),
            int(issuer_idx[i]), _table_key(log_id, key),
        ))
        self.stats["p384_lanes"] += 1
        incr_counter("verify", "p384_lanes")
        return True

    def _host_verify(self, lanes, scts, issuer_idx, rows, lengths) -> None:
        """The host lane: re-extract each lane's SCT from its row bytes
        (the compact batch does not carry these signatures) and judge it
        with the pure-python reference verifier."""
        verdicts = np.zeros((len(lanes),), bool)
        idx = np.zeros((len(lanes),), np.int64)
        for j, i in enumerate(lanes):
            der = rows[i, : int(lengths[i])].tobytes()
            _status, sc, _digest, _r, _s = sctlib.extract_sct_lane(der)
            key = self.keys.get(scts.log_id[i].tobytes())
            # Judged against the BATCH digest, which carries the lane's
            # issuer_key_hash.
            verdicts[j] = (sc is not None and key is not None
                           and sctlib.host_verify_sct(
                               scts.digest[i].tobytes(), sc, key))
            idx[j] = int(issuer_idx[i])
        self.stats["host_lanes"] += len(lanes)
        incr_counter("verify", "host_lanes", value=float(len(lanes)))
        self._fold_verdicts(verdicts, idx)

    # -- device lane -----------------------------------------------------
    def _lane(self, curve: str) -> _CurveLane:
        lane = self._lanes.get(curve)
        if lane is None:
            from ct_mapreduce_tpu_torch.ops import ecdsa

            lane = _CurveLane(ecdsa.CURVE_OPS[curve], self.window,
                              self.qtable_size)
            self._lanes[curve] = lane
        return lane

    def _ensure_tables(self, lane: _CurveLane) -> None:
        """Put the curve's G table and empty Q-table slots on the device
        (first dispatch only); the build time rides the
        verify.precomp_build_s sample when the process cache missed."""
        if lane.gtab is not None or lane.window == 0:
            return
        from ct_mapreduce_tpu_torch.ops import ecdsa

        lane.gtab, build_s = ecdsa.fixed_base_table(
            lane.ops, lane.window, self.device)
        if build_s > 0.0:
            add_sample("verify", "precomp_build_s", value=build_s)
        # Slots pow2-padded with the wrapper's floor, as the JAX lane
        # does; eviction is governed by `capacity` alone.
        slots = max(ecdsa.MIN_QTABLE_SLOTS,
                    1 << max(0, (lane.capacity - 1).bit_length()))
        lane.qtab = ecdsa.zero_qtable(
            slots, lane.ops.nbits // lane.window, 1 << lane.window,
            lane.ops.mod_p.nlimb, self.device)

    def _resolve_slots(self, lane: _CurveLane,
                       batch: list[tuple]) -> tuple[np.ndarray, int]:
        """Map staged lanes' table keys to Q-table slots, building and
        shipping missing tables (LRU eviction reuses the stalest slot).
        Slots referenced by THIS batch are pinned: eviction may only
        reclaim a slot no earlier lane of the batch reads. Returns
        ``(slots, consumed)``; consumed < len(batch) when the batch holds
        more distinct keys than the cache holds slots (the caller splits
        the dispatch)."""
        from ct_mapreduce_tpu_torch.ops import ecdsa

        slots = np.zeros((len(batch),), np.int32)
        pinned: set[int] = set()
        for j, entry in enumerate(batch):
            tabkey = entry[6]
            slot = lane.slot_of.get(tabkey)
            if slot is not None:
                lane.slot_of.move_to_end(tabkey)
                self.stats["qtable_hits"] += 1
                incr_counter("verify", "qtable_hits")
            else:
                if len(lane.slot_of) >= lane.capacity:
                    victim = next(
                        (k for k, sl in lane.slot_of.items()
                         if sl not in pinned), None)
                    if victim is None:  # every slot pinned: split here
                        return slots[:j], j
                    slot = lane.slot_of.pop(victim)
                else:
                    slot = len(lane.slot_of)
                lane.slot_of[tabkey] = slot
                np_tab, build_s = ecdsa.point_table_cached(
                    lane.ops, lane.window, tabkey[2], tabkey[3])
                if build_s > 0.0:
                    add_sample("verify", "qtable_build_s", value=build_s)
                ecdsa.qtable_slot_set(lane.qtab, slot, np_tab)
                self.stats["qtable_misses"] += 1
                incr_counter("verify", "qtable_misses")
            slots[j] = slot
            pinned.add(int(slot))
        set_gauge("verify", "qtable_occupancy",
                  value=float(lane.occupancy()))
        return slots, len(batch)

    def _dispatch(self, lane: _CurveLane, take: int) -> None:
        batch, lane.buf = lane.buf[:take], lane.buf[take:]
        while batch:
            batch = self._dispatch_some(lane, batch)

    def _dispatch_some(self, lane: _CurveLane,
                       batch: list[tuple]) -> list[tuple]:
        """Queue as many of ``batch``'s lanes as the Q-table can serve in
        one launch; returns the unserved tail (non-empty only when one
        batch references more distinct log keys than
        ``verifyQTableSize`` slots)."""
        from ct_mapreduce_tpu_torch.ops import ecdsa

        key_idx = None
        if lane.window > 0:
            self._ensure_tables(lane)
            slots, consumed = self._resolve_slots(lane, batch)
            batch, rest = batch[:consumed], batch[consumed:]
            key_idx = np.zeros((self.batch_width,), np.int32)
            key_idx[:consumed] = slots
        else:
            rest = []
        n = len(batch)
        w = self.batch_width  # one width per verifier
        dev = self.device

        def rows(k):
            a = np.zeros((w, lane.ops.byte_len), np.uint8)
            a[:n] = np.stack([b[k] for b in batch])
            return torch.from_numpy(a).to(dev, non_blocking=True)

        valid = np.zeros((w,), bool)
        valid[:n] = True
        args = [rows(k) for k in range(5)]
        valid_t = torch.from_numpy(valid).to(dev, non_blocking=True)
        with trace.span("device.verify", cat="device", lanes=n,
                        curve=lane.ops.name):
            if lane.window == 0:
                out = ecdsa.verify_jacobian(lane.ops, *args, valid_t)
            else:
                out = ecdsa.verify_windowed(
                    lane.ops, *args, valid_t,
                    torch.from_numpy(key_idx).to(dev, non_blocking=True),
                    lane.gtab, lane.qtab)
        self.stats["batches"] += 1
        self.stats["device_lanes"] += n
        incr_counter("verify", "batches")
        incr_counter("verify", "device_lanes", value=float(n))
        add_sample("verify", "batch_lanes", value=float(n))
        self._inflight.append(_PendingVerify(
            out, n, np.array([b[5] for b in batch], np.int64)))
        return rest

    def _drain_inflight(self, keep: int) -> None:
        while len(self._inflight) > keep:
            p = self._inflight.popleft()
            verdicts = p.out[: p.n].cpu().numpy()  # the blocking read
            self._fold_verdicts(verdicts, p.issuer_idx)

    def _fold_verdicts(self, verdicts: np.ndarray,
                       issuer_idx: np.ndarray) -> None:
        if len(verdicts) == 0:
            return
        v = int(verdicts.sum())
        f = len(verdicts) - v
        self.stats["verified"] += v
        self.stats["failed"] += f
        if v:
            incr_counter("verify", "verified", value=float(v))
        if f:
            incr_counter("verify", "failed", value=float(f))
        agg = self.agg
        with agg._fold_lock:
            agg.grow_verify_totals(int(issuer_idx.max(initial=0)))
            np.add.at(agg.verify_verified, issuer_idx, verdicts)
            np.add.at(agg.verify_failed, issuer_idx, ~verdicts)

    def drain(self) -> None:
        """Flush the staging buffers (each tail padded to the batch
        width) and fold every outstanding batch."""
        for lane in self._lanes.values():
            while lane.buf:
                self._dispatch(lane, min(len(lane.buf), self.batch_width))
        self._drain_inflight(0)

    def health(self) -> dict:
        """The /healthz ``verify`` section: knobs, outcome totals and
        per-curve Q-table occupancy."""
        return {
            "window": self.window,
            "stats": dict(self.stats),
            "qtable": {
                name: {
                    "capacity": lane.capacity,
                    "occupancy": lane.occupancy(),
                }
                for name, lane in sorted(self._lanes.items())
            },
        }


def _table_key(log_id: bytes, key: dict) -> tuple:
    """Q-table cache identity: the registry entry + its registration
    epoch (re-registration invalidates just this key) + coordinates
    (what the table bytes depend on)."""
    return (log_id, key.get("_epoch", 0),
            int(key["x"], 16), int(key["y"], 16))


def _key_coord(key: dict, name: str, nbytes: int = 32) -> np.ndarray:
    c = key.get(f"_{name}_bytes_{nbytes}")
    if c is None:
        c = np.frombuffer(
            int(key[name], 16).to_bytes(nbytes, "big"), np.uint8)
        key[f"_{name}_bytes_{nbytes}"] = c  # parse hex once per key
    return c
