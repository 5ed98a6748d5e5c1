"""Multi-worker ingest: partitioned log feed and a leader-coordinated
worker lifecycle (port of ``ct_mapreduce_tpu.ingest.fleet``; a copy of
its host code, the ``jax`` fabric moved onto ``torch.distributed``).

The reference scales out by running N independent ct-fetch processes
coordinated through Redis — SETNX leader election plus a polled start
barrier (reference coordinator/coordinator.go:44-138) — with the
log space split between them by operator config. This module makes
that a first-class mode of THIS binary, MapReduce-style (worker-
partitioned input, master-coordinated lifecycle, re-execution on
failure):

- **Partitioned feed** (`partition_map` / `partition_logs` /
  `partition_range`): a deterministic rendezvous hash over
  ``(worker_id, num_workers, log_url)`` assigns every configured CT
  log to exactly one worker, so no two workers fetch or double-count
  the same entries. A fleet pointed at ONE huge log instead splits its
  entry-index space into contiguous per-worker stripes
  (``partition_range``), each with its own durable cursor
  (``state_suffix`` in :class:`~ct_mapreduce_tpu_torch.ingest.sync.LogWorker`).
  Partition maps are pure functions of the membership — every worker
  computes the same map with no communication — and are surfaced in
  ``/healthz`` via :meth:`FleetService.stats`.

- **Leader-coordinated lifecycle** (:class:`FleetCoordinator`
  implementations): one protocol over both fabrics — the Redis-parity
  :class:`~ct_mapreduce_tpu_torch.coordinator.coordinator.Coordinator`
  (works against a real Redis or the in-tree miniredis) and the
  ``torch.distributed`` process group (:class:`DistFleetCoordinator`,
  ``coordinatorBackend = jax`` as in the JAX package's inis). Leader
  election, a start barrier, periodic per-worker heartbeats with a
  liveness timeout, and leader-published **epoch** ticks: the leader
  bumps a shared epoch counter every ``checkpointPeriod``, and every
  worker checkpoints when it observes the epoch advance — so the
  fleet's durable state moves in (approximate) lockstep instead of N
  free-running save tickers. A clean-shutdown broadcast rides the same
  value fabric.

- **Durable warm-restart**: checkpoints pair the aggregator's atomic
  ``.npz`` snapshot (write-to-temp + rename,
  :meth:`~ct_mapreduce_tpu_torch.agg.aggregator.TorchAggregator.save_checkpoint`)
  with the per-log fetch cursors (``CertificateLog`` stamps, saved
  cursor-after-aggregate so the cursor never outruns durable aggregate
  state). A SIGKILLed worker resumes from its last checkpoint cursor —
  replaying only the post-checkpoint tail, which the dedup table folds
  idempotently — instead of re-fetching the log from entry zero.

Per-worker aggregates merge into one storage-statistics view through
:mod:`ct_mapreduce_tpu_torch.agg.merge` (serial-set union + counter sum over
each worker's own drained snapshot).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Callable, Iterable, Optional, Protocol, Sequence

from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.telemetry import metrics

# Cache key namespaces (alongside the reference's leader-/started-).
HEARTBEAT_KEY_PREFIX = "fleet-hb-"
EPOCH_KEY_PREFIX = "fleet-epoch-"
STOP_KEY_PREFIX = "fleet-stop-"
CLAIM_KEY_PREFIX = "fleet-claim-"
OBS_KEY_PREFIX = "fleet-obs-"
DONE_KEY_PREFIX = "fleet-done-"

# A shutdown broadcast only needs to outlive every worker's observation
# poll (sub-second); the TTL bounds how long a stale broadcast can
# survive in a PERSISTENT Redis after the fleet is gone.
STOP_KEY_LIFE = timedelta(minutes=5)
# A done marker only matters while its worker's heartbeat is still live
# (a lapsed worker is not waited for), so it need only outlive that.
DONE_KEY_LIFE = timedelta(minutes=5)


# -- deterministic partitioner ------------------------------------------


def _weight(worker_id: int, num_workers: int, log_url: str) -> bytes:
    """Rendezvous (highest-random-weight) score of one (worker, log)
    pair. sha256 — NOT Python's randomized hash() — so every process
    in the fleet computes identical weights."""
    return hashlib.sha256(
        f"{worker_id}/{num_workers}/{log_url}".encode()
    ).digest()


def rendezvous_owner(log_url: str, num_workers: int,
                     candidates: Optional[Sequence[int]] = None) -> int:
    """The worker that owns ``log_url``: argmax of the rendezvous
    weight over ``candidates`` (default: all configured workers).
    Passing the alive subset reassigns only the dead owners' logs —
    the minimal-disruption property rendezvous hashing exists for."""
    ids = range(num_workers) if candidates is None else candidates
    return max(ids, key=lambda w: _weight(w, num_workers, log_url))


def partition_map(log_urls: Iterable[str], num_workers: int,
                  alive: Optional[Sequence[int]] = None) -> dict[str, int]:
    """log_url → owning worker id, deterministic for a given
    membership. With ``alive`` given, logs whose configured owner is
    dead re-home to the alive worker with the next-highest weight;
    logs with live owners never move."""
    out: dict[str, int] = {}
    for url in log_urls:
        owner = rendezvous_owner(url, num_workers)
        if alive is not None and owner not in alive and alive:
            owner = rendezvous_owner(url, num_workers, candidates=alive)
        out[url] = owner
    return out


def partition_logs(log_urls: Sequence[str], worker_id: int,
                   num_workers: int,
                   alive: Optional[Sequence[int]] = None) -> list[str]:
    """The subset of ``log_urls`` this worker fetches (order
    preserved)."""
    owners = partition_map(log_urls, num_workers, alive=alive)
    return [u for u in log_urls if owners[u] == worker_id]


def partition_range(tree_size: int, worker_id: int,
                    num_workers: int) -> tuple[int, int]:
    """(offset, limit) stripe of a single log's entry-index space for
    one worker: contiguous, disjoint, covering. Workers past the tree
    size get ``limit == 0`` (nothing to fetch)."""
    if num_workers <= 1:
        return 0, tree_size
    base, rem = divmod(max(tree_size, 0), num_workers)
    offset = worker_id * base + min(worker_id, rem)
    limit = base + (1 if worker_id < rem else 0)
    return offset, limit


def worker_state_path(path: str, worker_id: int, num_workers: int) -> str:
    """Per-worker aggregate-snapshot path: ``agg.npz`` →
    ``agg.w3.npz`` (suffix appended when there is no extension).
    Identity for single-worker runs, so existing configs keep their
    exact paths."""
    if not path or num_workers <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.w{worker_id}{ext}"


_FLEET_KNOBS = (
    platprofile.Knob("numWorkers", "CTMR_NUM_WORKERS", 1,
                     parse=int, is_set=platprofile.pos_int,
                     post=lambda v: max(1, int(v))),
    # -1 = unset; 0 is a REAL id (the one id every fleet must have
    # exactly once), so a config that pins workerId = 0 must beat a
    # stray env value.
    platprofile.Knob("workerId", "CTMR_WORKER_ID", 0,
                     parse=int, is_set=platprofile.nonneg_int,
                     post=lambda v: max(0, int(v))),
    platprofile.Knob("checkpointPeriod", "CTMR_CHECKPOINT_PERIOD", "",
                     parse=str, is_set=platprofile.nonempty_str),
    platprofile.Knob("coordinatorBackend", "CTMR_COORDINATOR", "",
                     parse=str, is_set=platprofile.nonempty_str),
)


def resolve_fleet(num_workers: int = 0, worker_id: int = -1,
                  checkpoint_period: str = "",
                  backend: str = "") -> tuple[int, int, str, str]:
    """Resolve the fleet knobs through the shared platformProfile
    ladder (config/profile.py): explicit value (config directive) >
    ``CTMR_NUM_WORKERS`` / ``CTMR_WORKER_ID`` /
    ``CTMR_CHECKPOINT_PERIOD`` / ``CTMR_COORDINATOR`` env > profile
    ``knobs.fleet`` > defaults (1 worker, id 0, no checkpoint cadence,
    auto backend). ``worker_id`` uses -1 as its unset sentinel.
    Unparseable env values are ignored, matching the config layer's
    tolerance."""
    r = platprofile.resolve_section("fleet", _FLEET_KNOBS, {
        "numWorkers": int(num_workers or 0),
        "workerId": int(worker_id),
        "checkpointPeriod": checkpoint_period,
        "coordinatorBackend": backend,
    })
    return (r["numWorkers"], r["workerId"], r["checkpointPeriod"],
            r["coordinatorBackend"])


# -- the coordinator protocol -------------------------------------------


class FleetCoordinator(Protocol):
    """One lifecycle contract over both coordination fabrics.

    ``start()`` contends for leadership (returns True iff won);
    ``barrier()`` releases every worker at once (leader publishes,
    followers wait); ``heartbeat()`` refreshes this worker's liveness
    lease; ``alive_workers()`` maps live worker ids to heartbeat ages;
    ``publish_epoch``/``current_epoch`` carry the leader's checkpoint
    cadence ticks; ``request_shutdown``/``shutdown_requested`` the
    clean-shutdown broadcast. ``fleet_started`` (after ``start()``)
    reports whether the current leadership already published its start
    barrier — i.e. this worker is REJOINING a running fleet;
    ``publish_start`` lets a rejoining leader re-publish the barrier
    without waiting for full membership. ``claim_log``/``release_log``
    are the per-log fetch lease: at most one worker holds a log at a
    time, so partition-map disagreement windows (dead-owner takeover
    racing the owner's warm restart) cannot double-fetch.
    ``publish_obs``/``fleet_obs`` carry each worker's TTL'd
    observability payload (metrics snapshot + clock pair, compact
    JSON) over the same value fabric — the metrics fan-in feed behind
    ``/metrics/fleet`` and ``/healthz/fleet``. ``mark_done``/
    ``done_workers`` carry each worker's end-of-run marker (its final
    save is durable), which the leader waits on before folding the
    fleet's last merged filter (:meth:`FleetService.finish`)."""

    worker_id: int
    num_workers: int

    def start(self) -> bool: ...
    def barrier(self, timeout_s: Optional[float] = None) -> None: ...
    def fleet_started(self) -> bool: ...
    def publish_start(self) -> None: ...
    def heartbeat(self) -> None: ...
    def alive_workers(self) -> dict[int, float]: ...
    def maybe_promote(self) -> bool: ...
    def publish_epoch(self, epoch: int) -> None: ...
    def current_epoch(self) -> int: ...
    def request_shutdown(self, reason: str) -> None: ...
    def shutdown_requested(self) -> Optional[str]: ...
    def claim_log(self, log_url: str) -> bool: ...
    def release_log(self, log_url: str) -> None: ...
    def publish_obs(self, payload: str) -> None: ...
    def fleet_obs(self) -> dict[int, str]: ...
    def mark_done(self) -> None: ...
    def done_workers(self) -> set[int]: ...
    def close(self) -> None: ...


class SoloFleetCoordinator:
    """The degenerate single-worker fleet: always leader, barrier and
    heartbeats are no-ops, epoch/shutdown are local state. Lets the
    checkpoint-cadence machinery run identically in one-process
    deployments (and in tests) without a cache."""

    def __init__(self, name: str = "ct-fetch"):
        self.name = name
        self.worker_id = 0
        self.num_workers = 1
        self.is_leader = True
        self._epoch = 0
        self._stop: Optional[str] = None
        self._done = False
        self._beat = time.monotonic()

    def start(self) -> bool:
        return True

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        pass

    def fleet_started(self) -> bool:
        return False

    def publish_start(self) -> None:
        pass

    def heartbeat(self) -> None:
        self._beat = time.monotonic()

    def alive_workers(self) -> dict[int, float]:
        return {0: time.monotonic() - self._beat}

    def maybe_promote(self) -> bool:
        return False

    def publish_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def current_epoch(self) -> int:
        return self._epoch

    def request_shutdown(self, reason: str) -> None:
        self._stop = reason or "stop"

    def shutdown_requested(self) -> Optional[str]:
        return self._stop

    def claim_log(self, log_url: str) -> bool:
        return True  # sole worker: every log is uncontended

    def release_log(self, log_url: str) -> None:
        pass

    def publish_obs(self, payload: str) -> None:
        self._obs = payload

    def fleet_obs(self) -> dict[int, str]:
        obs = getattr(self, "_obs", None)
        return {0: obs} if obs is not None else {}

    def mark_done(self) -> None:
        self._done = True

    def done_workers(self) -> set[int]:
        return {0} if self._done else set()

    def close(self) -> None:
        pass


class CacheFleetCoordinator:
    """The Redis-fabric coordinator: reference-parity SETNX election +
    start barrier (:class:`~ct_mapreduce_tpu_torch.coordinator.coordinator.
    Coordinator`) extended with heartbeats, epoch publishing, and the
    shutdown broadcast over the same :class:`RemoteCache`.

    Heartbeats are TTL'd value writes (``fleet-hb-<name>-<id>`` →
    wall-clock stamp, expiring after ``liveness_timeout_s``): a worker
    is alive iff its key exists, and the stamp gives the age. The
    leader's election lease is the reference's own renewal-thread
    scheme; followers call :meth:`maybe_promote` when the leader's
    heartbeat disappears, and whoever wins the (now-expired) SETNX
    inherits leadership — elastic failover, exactly as the reference's
    lease expiry provides."""

    def __init__(self, cache, name: str, worker_id: int, num_workers: int,
                 liveness_timeout_s: float = 15.0,
                 poll_period_s: float = 0.05,
                 key_life_initial: timedelta = timedelta(minutes=5),
                 key_life_renewal: timedelta = timedelta(minutes=2)):
        from ct_mapreduce_tpu_torch.coordinator.coordinator import Coordinator

        self.cache = cache
        self.name = name
        self.worker_id = int(worker_id)
        self.num_workers = int(num_workers)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.poll_period_s = float(poll_period_s)
        self.is_leader = False
        self._coord = Coordinator(
            cache, name,
            key_life_initial=key_life_initial,
            key_life_renewal=key_life_renewal,
            await_sleep_period_s=poll_period_s,
        )

    # -- keys ------------------------------------------------------------
    def _hb_key(self, worker_id: int) -> str:
        return f"{HEARTBEAT_KEY_PREFIX}{self.name}-{worker_id}"

    @property
    def _epoch_key(self) -> str:
        return EPOCH_KEY_PREFIX + self.name

    @property
    def _stop_key(self) -> str:
        return STOP_KEY_PREFIX + self.name

    def _claim_key(self, log_url: str) -> str:
        digest = hashlib.sha256(log_url.encode()).hexdigest()[:16]
        return f"{CLAIM_KEY_PREFIX}{self.name}-{digest}"

    def _obs_key(self, worker_id: int) -> str:
        return f"{OBS_KEY_PREFIX}{self.name}-{worker_id}"

    def _done_key(self, worker_id: int) -> str:
        return f"{DONE_KEY_PREFIX}{self.name}-{worker_id}"

    def _clear_key(self, key: str) -> None:
        """RemoteCache has no DEL; EXPIREAT in the past is the
        portable equivalent (Redis deletes the key immediately; the
        mock and miniredis purge it on the next touch)."""
        self.cache.expire_at(
            key, datetime(1970, 1, 2, tzinfo=timezone.utc))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> bool:
        # Absorb a stale shutdown broadcast before anything can observe
        # it: against a PERSISTENT Redis, the previous run's signal-
        # driven stop key would otherwise self-terminate this run the
        # moment the service loop starts (the stop-key analog of
        # FleetService initializing _epoch_seen from current_epoch()).
        self._clear_key(self._stop_key)
        # Likewise this worker's done marker from a previous run.
        self._clear_key(self._done_key(self.worker_id))
        self.heartbeat()
        self.is_leader = self._coord.await_leader()
        return self.is_leader

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        """Leader: wait until every configured worker has a live
        heartbeat, then publish the start key. Followers: poll for it
        (coordinator.go:87-138 semantics)."""
        if not self.is_leader:
            self._coord.await_start(timeout_s=timeout_s)
            return
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while len(self.alive_workers()) < self.num_workers:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"start barrier: {sorted(self.alive_workers())} of "
                    f"{self.num_workers} workers present")
            time.sleep(self.poll_period_s)
        self._coord.send_start()

    def fleet_started(self) -> bool:
        """After ``start()``: has the CURRENT leadership already
        published its start barrier? True means this worker is
        rejoining a running fleet (its own barrier crossing happened in
        a previous incarnation) and must not block on — or re-form —
        the barrier. Scoped to the incumbent's election identifier, so
        a fresh fleet on a persistent Redis never false-positives on
        another run's leftovers (started keys are TTL'd and named by
        identifier)."""
        from ct_mapreduce_tpu_torch.coordinator.coordinator import (
            STARTED_KEY_PREFIX,
        )

        ident = self._coord.identifier
        if not ident or self._coord.is_leader:
            # A leader's own started key can't predate its election:
            # identifiers are unique per await_leader() call.
            return False
        return self.cache.exists(STARTED_KEY_PREFIX + ident)

    def publish_start(self) -> None:
        """Leader-only: publish the start barrier WITHOUT waiting for
        full membership — the rejoin path (a restarted worker that
        inherited an expired lease must release any followers polling
        the barrier, and full membership may never re-form if peers
        already finished)."""
        self._coord.send_start()

    def heartbeat(self) -> None:
        self.cache.put(
            self._hb_key(self.worker_id), repr(time.time()),
            life=timedelta(seconds=self.liveness_timeout_s),
        )

    def alive_workers(self) -> dict[int, float]:
        now = time.time()
        out: dict[int, float] = {}
        for w in range(self.num_workers):
            raw = self.cache.get(self._hb_key(w))
            if raw is None:
                continue
            try:
                age = max(0.0, now - float(raw))
            except ValueError:
                age = 0.0
            out[w] = age
        return out

    def maybe_promote(self) -> bool:
        """Re-contend for leadership (no-op while someone else's lease
        is live — try_set loses). Returns True iff this worker just
        became leader."""
        if self.is_leader:
            return False
        self.is_leader = self._coord.await_leader()
        return self.is_leader

    # -- epoch / shutdown fabric ----------------------------------------
    def publish_epoch(self, epoch: int) -> None:
        self.cache.put(self._epoch_key, str(int(epoch)))

    def current_epoch(self) -> int:
        raw = self.cache.get(self._epoch_key)
        try:
            return int(raw) if raw else 0
        except ValueError:
            return 0

    def request_shutdown(self, reason: str) -> None:
        # TTL'd so a persistent Redis can't replay this broadcast into
        # a later run forever (start() also clears it defensively).
        self.cache.put(self._stop_key, reason or "stop",
                       life=STOP_KEY_LIFE)

    def shutdown_requested(self) -> Optional[str]:
        return self.cache.get(self._stop_key) or None

    # -- per-log fetch lease ---------------------------------------------
    def claim_log(self, log_url: str) -> bool:
        """Acquire (or re-affirm) the exclusive fetch lease on one log.
        SETNX with the worker id as the value: the holder re-affirms
        (refreshing the TTL — the renewal rides the FleetService
        heartbeat loop), everyone else is refused until the lease
        expires or is released. This is what makes dead-owner takeover
        safe against the owner's warm restart: both may COMPUTE
        ownership of the same log in the disagreement window, but only
        one can hold the lease, so entries are never fetched twice
        concurrently (agg/merge.py's disjointness assumption)."""
        me = str(self.worker_id)
        life = timedelta(seconds=self.liveness_timeout_s)
        holder = self.cache.try_set(self._claim_key(log_url), me, life)
        if holder != me:
            return False
        self.cache.put(self._claim_key(log_url), me, life=life)
        return True

    def release_log(self, log_url: str) -> None:
        if self.cache.get(self._claim_key(log_url)) == str(self.worker_id):
            self._clear_key(self._claim_key(log_url))

    # -- observability fan-in ---------------------------------------------
    def publish_obs(self, payload: str) -> None:
        """TTL'd like the heartbeat: a stalled worker's payload ages
        out of the fleet view on the same liveness clock that marks it
        dead, so the rollup never reports fresh-looking numbers from a
        SIGSTOP'd process."""
        self.cache.put(self._obs_key(self.worker_id), payload,
                       life=timedelta(seconds=self.liveness_timeout_s))

    def fleet_obs(self) -> dict[int, str]:
        out: dict[int, str] = {}
        for w in range(self.num_workers):
            raw = self.cache.get(self._obs_key(w))
            if raw is not None:
                out[w] = raw
        return out

    def mark_done(self) -> None:
        self.cache.put(self._done_key(self.worker_id), "1",
                       life=DONE_KEY_LIFE)

    def done_workers(self) -> set[int]:
        return {w for w in range(self.num_workers)
                if self.cache.exists(self._done_key(w))}

    def close(self) -> None:
        self._coord.close()


class DistFleetCoordinator:
    """The process-group fabric: leadership is rank 0, the barrier a
    collective (parallel/distributed.py), liveness the group's own (a
    dead rank fails the collectives), and the epoch/shutdown values ride
    the group's TCP store. Without a process group (one process) it
    keeps local values, so the cadence machinery still works. Selected
    by ``coordinatorBackend = jax``, the JAX package's spelling, so one
    ini runs on both packages."""

    def __init__(self, name: str = "ct-fetch"):
        from ct_mapreduce_tpu_torch.parallel import distributed
        from ct_mapreduce_tpu_torch.parallel.distributed import (
            DistributedCoordinator,
        )

        self.name = name
        self.worker_id = distributed.rank()
        self.num_workers = distributed.world_size()
        self.is_leader = False
        self._coord = DistributedCoordinator(name)
        self._local_epoch = 0
        self._local_stop: Optional[str] = None
        self._local_done = False
        self._beat = time.monotonic()

    def start(self) -> bool:
        self.is_leader = self._coord.await_leader()
        return self.is_leader

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        if self.num_workers <= 1:
            return
        if self.is_leader:
            self._coord.send_start()
        else:
            self._coord.await_start(timeout_s=timeout_s)

    def fleet_started(self) -> bool:
        # A process group forms collectively: a dead rank tears the job
        # down, so a single worker can never rejoin a running fleet —
        # every start is a cold start.
        return False

    def publish_start(self) -> None:
        if self.is_leader:
            self._coord.send_start()

    def heartbeat(self) -> None:
        self._beat = time.monotonic()

    def alive_workers(self) -> dict[int, float]:
        # The runtime evicts dead processes itself; every configured
        # worker that hasn't torn the job down is live by contract.
        return {w: 0.0 for w in range(self.num_workers)}

    def maybe_promote(self) -> bool:
        return False  # host-0 leadership is fixed by the runtime

    def _kv(self, key: str) -> str:
        return f"fleet/{self.name}/{key}"

    def publish_epoch(self, epoch: int) -> None:
        from ct_mapreduce_tpu_torch.parallel import distributed

        if not distributed.kv_put(self._kv("epoch"), str(int(epoch))):
            self._local_epoch = int(epoch)

    def current_epoch(self) -> int:
        from ct_mapreduce_tpu_torch.parallel import distributed

        raw = distributed.kv_get(self._kv("epoch"))
        if raw is None:
            return self._local_epoch
        try:
            return int(raw)
        except ValueError:
            return 0

    def request_shutdown(self, reason: str) -> None:
        from ct_mapreduce_tpu_torch.parallel import distributed

        if not distributed.kv_put(self._kv("stop"), reason or "stop"):
            self._local_stop = reason or "stop"

    def shutdown_requested(self) -> Optional[str]:
        from ct_mapreduce_tpu_torch.parallel import distributed

        raw = distributed.kv_get(self._kv("stop"))
        return raw if raw is not None else self._local_stop

    def claim_log(self, log_url: str) -> bool:
        # Membership is fixed by the runtime (alive_workers is always
        # the full set), so ownership never moves and leases are moot.
        return True

    def release_log(self, log_url: str) -> None:
        pass

    def publish_obs(self, payload: str) -> None:
        from ct_mapreduce_tpu_torch.parallel import distributed

        if not distributed.kv_put(self._kv(f"obs/{self.worker_id}"),
                                  payload):
            self._local_obs = payload

    def fleet_obs(self) -> dict[int, str]:
        from ct_mapreduce_tpu_torch.parallel import distributed

        out: dict[int, str] = {}
        for w in range(self.num_workers):
            raw = distributed.kv_get(self._kv(f"obs/{w}"))
            if raw is not None:
                out[w] = raw
        local = getattr(self, "_local_obs", None)
        if local is not None and self.worker_id not in out:
            out[self.worker_id] = local
        return out

    def mark_done(self) -> None:
        from ct_mapreduce_tpu_torch.parallel import distributed

        if not distributed.kv_put(self._kv(f"done/{self.worker_id}"), "1"):
            self._local_done = True

    def done_workers(self) -> set[int]:
        from ct_mapreduce_tpu_torch.parallel import distributed

        out = {w for w in range(self.num_workers)
               if distributed.kv_get(self._kv(f"done/{w}")) is not None}
        if self._local_done:
            out.add(self.worker_id)
        return out

    def close(self) -> None:
        self._coord.close()


def build_coordinator(backend: str, cache, name: str, worker_id: int,
                      num_workers: int, **kwargs) -> FleetCoordinator:
    """``coordinatorBackend`` directive → coordinator: ``redis`` (the
    configured RemoteCache — a real Redis via ``redisHost``, miniredis,
    or the in-process mock), ``jax`` (the ``torch.distributed`` process
    group, the JAX package's spelling), ``solo``
    (single worker, no fabric). Empty picks ``redis`` for multi-worker
    configs and ``solo`` otherwise."""
    be = (backend or "").strip().lower()
    if not be:
        be = "redis" if num_workers > 1 else "solo"
    if be in ("solo", "none", "local"):
        return SoloFleetCoordinator(name)
    if be in ("redis", "cache"):
        if cache is None:
            raise ValueError("coordinatorBackend=redis needs a RemoteCache")
        if "liveness_timeout_s" not in kwargs:
            # CTMR_FLEET_LIVENESS_S shrinks the liveness TTL for test
            # harnesses that must observe a dead worker quickly (the
            # obs-smoke SIGSTOP leg); unparseable values are ignored,
            # matching the config layer's env tolerance.
            raw = os.environ.get("CTMR_FLEET_LIVENESS_S", "")
            try:
                if raw and float(raw) > 0:
                    kwargs["liveness_timeout_s"] = float(raw)
            except ValueError:
                pass
        return CacheFleetCoordinator(
            cache, name, worker_id, num_workers, **kwargs)
    if be == "jax":
        return DistFleetCoordinator(name)
    raise ValueError(f"unknown coordinatorBackend {backend!r} "
                     "(expected redis | jax | solo)")


# -- the per-worker service ---------------------------------------------


class FleetService:
    """One worker's view of the fleet: election + barrier at start,
    then a background loop that heartbeats, watches the leader-
    published epoch (running ``on_checkpoint`` whenever it advances —
    the leader itself bumps it every ``checkpoint_period_s``), watches
    the shutdown broadcast (``on_shutdown``), and re-contends for
    leadership when the leader's heartbeat lapses. ``partition``
    filters a log list down to this worker's share and records the map
    for ``stats()`` / ``/healthz``."""

    def __init__(self, coordinator: FleetCoordinator,
                 heartbeat_period_s: float = 2.0,
                 checkpoint_period_s: float = 0.0,
                 on_checkpoint: Optional[Callable[[int], None]] = None,
                 on_shutdown: Optional[Callable[[str], None]] = None,
                 obs_payload: Optional[Callable[[], str]] = None):
        self.coordinator = coordinator
        self.worker_id = coordinator.worker_id
        self.num_workers = coordinator.num_workers
        self.heartbeat_period_s = max(0.05, float(heartbeat_period_s))
        self.checkpoint_period_s = max(0.0, float(checkpoint_period_s))
        self.on_checkpoint = on_checkpoint
        self.on_shutdown = on_shutdown
        # Zero-arg compact-JSON provider published into the fabric on
        # every heartbeat (telemetry/fleetobs.py builds it) — the
        # metrics fan-in + clock-pair exchange feed.
        self.obs_payload = obs_payload
        self.obs_publishes = 0
        self.is_leader = False
        self.rejoined = False
        self.checkpoints_run = 0
        self.last_checkpoint_wall = 0.0
        self._epoch_seen = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._shutdown_seen = False
        self._lock = threading.Lock()
        self._partition: dict[str, int] = {}
        self._stripe: Optional[dict] = None
        self._claims: set[str] = set()
        self._errors: list[str] = []

    # -- lifecycle -------------------------------------------------------
    def start(self, timeout_s: Optional[float] = None,
              await_barrier: bool = True, rejoin: bool = False) -> bool:
        """Elect, heartbeat, cross the start barrier, and start the
        background loop. A RESTARTED worker rejoining a running fleet
        must never block the resume on the original barrier (long
        published, and peers may already have finished): a rejoin is
        detected from the coordinator (the incumbent leadership's
        published start key) or asserted by the caller via ``rejoin``
        (e.g. a durable per-worker checkpoint on disk). A rejoining
        worker that inherited an expired leader lease re-publishes the
        start key instead of waiting for membership that may never
        re-form. ``await_barrier=False`` skips the barrier outright."""
        self.is_leader = self.coordinator.start()
        self.coordinator.heartbeat()
        self.rejoined = bool(rejoin) or self.coordinator.fleet_started()
        if await_barrier and not self.rejoined:
            self.coordinator.barrier(timeout_s=timeout_s)
        elif self.rejoined and self.is_leader:
            self.coordinator.publish_start()
        self._epoch_seen = self.coordinator.current_epoch()
        self._thread = threading.Thread(
            target=self._loop, name="fleet", daemon=True)
        self._thread.start()
        return self.is_leader

    def finish(self, timeout_s: Optional[float] = None) -> list[int]:
        """End of this worker's run, after its final save: mark it done
        in the fabric. The leader then waits until no other worker is
        both live and not done (a worker whose heartbeat lapsed left its
        last checkpoint behind), so that what it folds next holds every
        worker's final state. Returns the workers still pending when
        ``timeout_s`` ran out (always empty on a follower)."""
        self.coordinator.mark_done()
        if not self.is_leader:
            return []
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            done = self.coordinator.done_workers()
            pending = sorted(w for w in self.coordinator.alive_workers()
                             if w != self.worker_id and w not in done)
            if not pending or (deadline is not None
                               and time.monotonic() >= deadline):
                return pending
            time.sleep(0.05)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.release_claims()
        self.coordinator.close()

    # -- background loop -------------------------------------------------
    def _loop(self) -> None:
        tick = min(self.heartbeat_period_s / 2.0, 0.25)
        next_beat = 0.0
        next_epoch_tick = (
            time.monotonic() + self.checkpoint_period_s
            if self.checkpoint_period_s else None)
        while not self._stop.wait(tick):
            try:
                now = time.monotonic()
                if now >= next_beat:
                    self.coordinator.heartbeat()
                    self._renew_claims()
                    self._publish_obs()
                    next_beat = now + self.heartbeat_period_s
                    self._observe_liveness()
                if (next_epoch_tick is not None and self.is_leader
                        and now >= next_epoch_tick):
                    self.coordinator.publish_epoch(
                        self.coordinator.current_epoch() + 1)
                    next_epoch_tick = now + self.checkpoint_period_s
                self._observe_epoch()
                self._observe_shutdown()
            except Exception as err:  # the loop must survive fabric blips
                with self._lock:
                    self._errors.append(f"{type(err).__name__}: {err}")
                    del self._errors[:-8]

    def _observe_liveness(self) -> None:
        alive = self.coordinator.alive_workers()
        metrics.set_gauge("fleet", "workers_alive", value=float(len(alive)))
        peer_ages = [a for w, a in alive.items() if w != self.worker_id]
        metrics.set_gauge("fleet", "heartbeat_age_s",
                          value=max(peer_ages, default=0.0))
        metrics.set_gauge("fleet", "is_leader",
                          value=1.0 if self.is_leader else 0.0)
        if not self.is_leader and self.coordinator.maybe_promote():
            self.is_leader = True

    def _publish_obs(self) -> None:
        if self.obs_payload is None:
            return
        try:
            payload = self.obs_payload()
        except Exception:
            return  # a snapshot failure must not stop the heartbeat
        if payload:
            self.coordinator.publish_obs(payload)
            self.obs_publishes += 1
            metrics.incr_counter("fleet", "obs_publishes")

    def fleet_obs(self) -> dict[int, str]:
        """Every live worker's published observability payload
        (worker id → compact JSON string, this worker included)."""
        return self.coordinator.fleet_obs()

    def _observe_epoch(self) -> None:
        epoch = self.coordinator.current_epoch()
        if epoch <= self._epoch_seen:
            return
        self._epoch_seen = epoch
        metrics.set_gauge("fleet", "checkpoint_epoch", value=float(epoch))
        if self.on_checkpoint is not None:
            with metrics.measure("fleet", "checkpoint_s"):
                self.on_checkpoint(epoch)
        self.checkpoints_run += 1
        self.last_checkpoint_wall = time.time()
        metrics.incr_counter("fleet", "checkpoint_count")

    def _observe_shutdown(self) -> None:
        if self._shutdown_seen:
            return
        reason = self.coordinator.shutdown_requested()
        if reason:
            self._shutdown_seen = True
            if self.on_shutdown is not None:
                self.on_shutdown(reason)

    # -- feed partitioning ----------------------------------------------
    def partition(self, log_urls: Sequence[str],
                  takeover: bool = False) -> list[str]:
        """This worker's share of the configured logs. With
        ``takeover`` (runForever rounds), logs whose configured owner
        has no live heartbeat re-home to live workers; one-shot runs
        stay on the configured map (the start barrier guaranteed full
        membership)."""
        alive = (sorted(self.coordinator.alive_workers())
                 if takeover else None)
        with self._lock:
            self._partition = partition_map(
                log_urls, self.num_workers, alive=alive)
            mine = [u for u in log_urls
                    if self._partition[u] == self.worker_id]
        metrics.set_gauge("fleet", "partition_size", value=float(len(mine)))
        return mine

    def stripe(self, tree_size: int) -> tuple[int, int]:
        """This worker's entry-index stripe of a single log."""
        return partition_range(tree_size, self.worker_id, self.num_workers)

    # -- per-log fetch leases --------------------------------------------
    def claim(self, log_url: str) -> bool:
        """Take the exclusive fetch lease on one partitioned log for
        this round; the background loop renews held leases every
        heartbeat. A refusal means another worker (takeover survivor
        or the restarted owner, whichever won) is mid-fetch — skip the
        log this round and re-contend on the next one."""
        ok = self.coordinator.claim_log(log_url)
        if ok:
            with self._lock:
                self._claims.add(log_url)
        metrics.set_gauge("fleet", "claims_held",
                          value=float(len(self._claims)))
        return ok

    def release_claims(self) -> None:
        """Drop every held lease (end of a sync round / shutdown) so
        the next round's rightful owners can take them."""
        with self._lock:
            claims, self._claims = sorted(self._claims), set()
        for url in claims:
            try:
                self.coordinator.release_log(url)
            except Exception:
                pass  # an unreleased lease just expires with its TTL
        metrics.set_gauge("fleet", "claims_held", value=0.0)

    def _renew_claims(self) -> None:
        with self._lock:
            claims = sorted(self._claims)
        for url in claims:
            self.coordinator.claim_log(url)

    def note_stripe(self, log_url: str, offset: int, limit: int) -> None:
        """Record a single-log entry-range assignment for stats() (the
        whole-log partition map doesn't apply in stripe mode)."""
        with self._lock:
            self._stripe = {"log_url": log_url, "offset": offset,
                            "limit": limit}
        metrics.set_gauge("fleet", "partition_size",
                          value=1.0 if limit > 0 else 0.0)

    def request_shutdown(self, reason: str) -> None:
        self.coordinator.request_shutdown(reason)

    def shutdown_requested(self) -> Optional[str]:
        return self.coordinator.shutdown_requested()

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        """The ``/healthz`` fleet section: role, membership, heartbeat
        ages, the checkpoint epoch, and the current partition map."""
        alive = self.coordinator.alive_workers()
        with self._lock:
            partition = dict(self._partition)
            stripe = dict(self._stripe) if self._stripe else None
            claims = sorted(self._claims)
            errors = list(self._errors)
        body = {
            "role": "leader" if self.is_leader else "follower",
            "worker_id": self.worker_id,
            "num_workers": self.num_workers,
            "rejoined": self.rejoined,
            "claims": claims,
            "workers_alive": sorted(alive),
            "heartbeat_age_s": {str(w): round(a, 3)
                                for w, a in sorted(alive.items())},
            "checkpoint_epoch": self._epoch_seen,
            "checkpoints_run": self.checkpoints_run,
            "last_checkpoint_wall": self.last_checkpoint_wall,
            "obs_publishes": self.obs_publishes,
            "partition": partition,
        }
        if stripe is not None:
            body["stripe"] = stripe
        if errors:
            body["errors"] = errors
        return body
