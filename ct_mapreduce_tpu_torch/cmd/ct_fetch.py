"""ct-fetch: continuous CT-log ingest (a port of
``ct_mapreduce_tpu.cmd.ct_fetch``).

The reference binary (reference cmd/ct-fetch/ct-fetch.go:490-638):
config init → storage wiring → telemetry → sync engine + store workers
→ one downloader per log → health endpoint → signal-driven shutdown →
optional runForever polling loop.

``backend = tpu`` keeps the JAX package's directive and value: entries
are packed into device batches and reduced by the port's aggregator,
on CUDA unless the caller asks for the CPU (``main(device="cpu")`` or
``-device cpu``); the aggregates checkpoint to ``aggStatePath`` for
``storage-statistics``. Any other backend stores entry by entry through
the database facade, as the reference does. ``profileDir`` writes a
``torch.profiler`` trace of the run (the JAX package writes a
``jax.profiler`` one).

``emitFilter`` compiles the aggregation state's per-(issuer, expDate)
serial sets into a filter artifact (``filterPath``, by default
``<aggStatePath>.filter``) after every checkpoint save, on the
aggregator's device (K1 and K5 on the card); ``filterFpRate``,
``filterFormat``, ``filterStreamChunk``, ``filterFusedLanes`` and the
capture spill ring (``filterCaptureSpillDir``/``filterCaptureSpillMB``)
resolve through :func:`..filter.resolve_filter` as in the JAX package.

``numWorkers`` > 1 runs this process as one worker of a fleet
(``ingest/fleet.py``): ``workerId`` (or ``CTMR_WORKER_ID``) names it,
its logs are its rendezvous-hash share (or, with one log, its stripe of
the log's entries, each stripe with its own durable cursor), its state
and filter paths get a ``.w<id>`` suffix, and ``coordinatorBackend``
(``redis`` over the configured cache, ``jax`` over the
``torch.distributed`` process group of ``MASTER_ADDR``/``WORLD_SIZE``,
``solo``) elects a leader, releases the workers together and publishes
an epoch every ``checkpointPeriod``; each worker checkpoints when it
sees the epoch advance, and with ``emitFilter`` the leader folds every
worker's checkpoint into the fleet's merged filter at the unsuffixed
``filterPath`` (K1 and K5 on its device), which every worker's query
plane publishes. A tick folds whatever checkpoints are on disk; at the
end of the run every worker marks its final save done and the leader,
once the others are done (or their heartbeats lapsed), folds them all
one last time, so the artifact it leaves holds every worker's entries.
The JAX package leaves its last tick's build.

``queryPort`` starts the query plane (``serve/server.py``) over the
live aggregator, on the aggregator's device: membership answers from
pinned copies of the dedup table, ``/issuer``, ``/healthz`` and the
``/getcert`` proxy, while the run ingests. With ``emitFilter`` as well,
the plane arms its filter-first tier and the ``/filter*`` distribution
routes (``distribHistory`` epochs held, a full-snapshot anchor every
``maxDeltaChain`` links); the tier is rebuilt after every checkpoint
save and every round's save (:func:`refresh_serve_filter`), each rebuild
publishing one epoch.

``verifySignatures`` verifies the embedded SCT of every ingested
certificate against the keys of ``verifyLogKeys``: P-256 and P-384 keys
through the ECDSA verify K6 on the aggregator's device, RSA and
malformed lanes through the host verifier (``verifyBatch``,
``verifyPrecompWindow`` and ``verifyQTableSize`` tune it, as in the JAX
package); the verdicts ride the checkpoint into storage-statistics, and
the ``healthAddr`` body gains a ``verify`` section (the JAX package has
it on the ``metricsPort`` body, not ported yet).

Directives whose subsystem the port does not have yet raise a
``ValueError`` naming the ROADMAP item that brings it (see
:func:`refuse_unported`); none is silently ignored. The lock-order
witness (``CTMR_LOCK_WITNESS``, an environment switch, not a directive)
is not installed.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time

from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.config import profile as platprofile
from ct_mapreduce_tpu_torch.engine import get_configured_storage, prepare_telemetry
from ct_mapreduce_tpu_torch.ingest.fleet import (
    FleetService,
    build_coordinator,
    resolve_fleet,
    worker_state_path,
)
from ct_mapreduce_tpu_torch.ingest.health import HealthServer
from ct_mapreduce_tpu_torch.ingest.sync import (
    LogSyncEngine,
    build_sink,
    polling_delay,
)
from ct_mapreduce_tpu_torch.telemetry import flight, trace
from ct_mapreduce_tpu_torch.utils import parse_duration

# How long a fleet's leader waits at the end of its run for the other
# workers' final saves before it folds the last merged filter.
FLEET_FINISH_TIMEOUT_S = 3600.0


class ProgressPrinter:
    """Textual stand-in for the reference's mpb progress bars
    (ct-fetch.go:317-330); disabled by -nobars."""

    def __init__(self, engine: LogSyncEngine, period_s: float):
        self.engine = engine
        self.period_s = max(period_s, 0.05)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: dict[str, tuple[float, int]] = {}

    def _line(self) -> str:
        parts = []
        now = time.monotonic()
        for url, (pos, end) in sorted(self.engine.progress().items()):
            prev_t, prev_pos = self._last.get(url, (now, pos))
            rate = (pos - prev_pos) / (now - prev_t) if now > prev_t else 0.0
            self._last[url] = (now, pos)
            pct = 100.0 * pos / end if end else 100.0
            # ETA decorator parity with the reference's mpb bars
            # (ct-fetch.go:317-330).
            if rate > 0 and end > pos:
                secs = (end - pos) / rate
                eta = (f"{secs / 3600:.1f}h" if secs >= 3600
                       else f"{secs / 60:.0f}m" if secs >= 60
                       else f"{secs:.0f}s")
            else:
                eta = "--"
            parts.append(
                f"{url}: {pos}/{end} ({pct:.1f}%) {rate:,.0f}/s eta {eta}"
            )
        return " | ".join(parts)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            line = self._line()
            if line:
                print(f"\r{line}", end="", file=sys.stderr, flush=True)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="progress",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join()
        print(file=sys.stderr)


def refuse_unported(config: CTConfig) -> None:
    """Raise a ``ValueError`` naming the ROADMAP item of the first
    directive whose subsystem the port does not have yet."""
    unported = [
        (config.metrics_port != 0,
         "metricsPort (the Prometheus endpoint)", "item 14"),
        (config.fleet_metrics is True, "fleetMetrics (fleet observability)",
         "item 14"),
        (bool(config.slo_max_ingest_lag or config.slo_max_checkpoint_age
              or config.slo_max_filter_lag or config.slo_max_serve_p99_ms),
         "the SLO directives (fleet observability)", "item 14"),
    ]
    for needed, what, item in unported:
        if needed:
            raise ValueError(f"{what} is not ported yet "
                             f"(ROADMAP.md queue 1 {item})")


def fleet_assignments(fleet, log_urls: list[str],
                      takeover: bool = False,
                      errors: list | None = None) -> list[tuple]:
    """This worker's share of the feed as (url, offset, limit,
    state_suffix) download assignments. Multi-log fleets partition
    whole logs by rendezvous hash, then take the per-log fetch lease
    on each: a log whose lease another worker still holds (takeover
    racing the owner's restart) is skipped this round and re-contended
    next round, so no log is ever fetched by two workers at once. A
    fleet pointed at ONE log stripes its entry-index space instead
    (one STH fetch resolves the tree size), each stripe with its own
    durable cursor key; an STH failure is recorded in ``errors`` and
    yields an empty round (retried on the next poll) instead of
    killing the worker."""
    if fleet is None:
        return [(u, None, None, "") for u in log_urls]
    if fleet.num_workers <= 1:
        # Degenerate fleet: worker 0 owns everything, but the map
        # still computes so its stats show it.
        return [(u, None, None, "") for u in fleet.partition(log_urls)]
    if len(log_urls) == 1:
        from ct_mapreduce_tpu_torch.ingest.ctclient import CTLogClient

        url = log_urls[0]
        try:
            tree_size = CTLogClient(url).get_sth().tree_size
        except Exception as err:
            if errors is not None:
                errors.append(
                    f"{url}: STH fetch for stripe assignment failed: "
                    f"{err}")
            return []
        offset, limit = fleet.stripe(tree_size)
        fleet.note_stripe(url, offset, limit)
        if limit <= 0:
            return []  # more workers than entries: nothing for us
        return [(url, offset, limit, f"#w{fleet.worker_id}")]
    return [(u, None, None, "")
            for u in fleet.partition(log_urls, takeover=takeover)
            if fleet.claim(u)]


def slo_breaches() -> list:
    """The SLO rules' breach reasons, which the query plane's /healthz
    reads. The rules and their directives are ROADMAP item 14;
    :func:`refuse_unported` refuses those directives, so no rule is
    set and nothing breaches."""
    return []


def _pop_device(argv: list[str]) -> tuple[list[str], str]:
    """Take ``-device X`` / ``-device=X`` out of ``argv`` (the device is
    a property of the run, not a directive)."""
    out, device, i = [], "", 0
    while i < len(argv):
        a = argv[i]
        if a in ("-device", "--device") and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith(("-device=", "--device=")):
            device = a.split("=", 1)[1]
        else:
            out.append(a)
        i += 1
    return out, device


def _start_profiler():
    """A ``torch.profiler`` session over the run (host phases and, on
    CUDA, device kernels), or None when it cannot start."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, profile_dir: str) -> str:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"ct-fetch-{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv: list[str] | None = None, device=None) -> int:
    """Run ct-fetch. ``device`` (or the ``-device`` flag) names the
    device of ``backend = tpu``; CUDA when neither does."""
    argv = sys.argv[1:] if argv is None else list(argv)
    argv, flag_device = _pop_device(argv)
    device = device or flag_device or None
    config = CTConfig.load(argv)
    log_urls = config.log_urls()
    if not log_urls:
        print(config.usage(), file=sys.stderr)
        print("\nerror: logList is required", file=sys.stderr)
        return 2
    refuse_unported(config)

    # Platform profile: pin the tuned-knob data file before any
    # subsystem resolves its knobs.
    platprofile.set_active_profile(config.platform_profile)

    # Fleet resolution before any state path is used: each worker of a
    # multi-worker ingest keeps its own aggregate snapshot (agg.npz →
    # agg.w<id>.npz); storage-statistics merges them (aggStatePath glob).
    num_workers, fleet_worker_id, checkpoint_period, coord_backend = (
        resolve_fleet(config.num_workers, config.worker_id,
                      config.checkpoint_period, config.coordinator_backend))
    if fleet_worker_id >= num_workers:
        print(f"error: workerId {fleet_worker_id} outside "
              f"[0, numWorkers={num_workers})", file=sys.stderr)
        return 2
    if coord_backend.strip().lower() == "jax":
        # The process-group fabric: join the group MASTER_ADDR and
        # WORLD_SIZE name (a no-op without them).
        from ct_mapreduce_tpu_torch.parallel.distributed import (
            initialize_multihost,
        )

        initialize_multihost()
    base_state_path = config.agg_state_path
    config.agg_state_path = worker_state_path(
        config.agg_state_path, fleet_worker_id, num_workers)
    # A durable per-worker checkpoint on disk means this process is a
    # WARM RESTART rejoining a fleet that already crossed its start
    # barrier: it must not re-run the barrier, and its first round
    # partitions against the LIVE membership so logs a survivor took
    # over are not fetched twice.
    resuming = bool(config.agg_state_path
                    and os.path.exists(config.agg_state_path))

    database, _cache, _backend = get_configured_storage(config)
    dumper = prepare_telemetry("ct-fetch", config)
    if config.trace_path:
        trace.enable(config.trace_path)
    # Flight recorder: a crash dumps the trace ring + last metric
    # snapshots next to the run (CTMR_FLIGHT_DIR overrides the
    # directory). Uninstalled in the finally: main() leaves no global
    # hooks behind, it is re-entered by tests and runForever wrappers.
    flight.install(signals=False, excepthook=False)
    if config.issuer_cn_filter:
        # The reference logs a stale "unsupported" warning here
        # (ct-fetch.go:498-499) but enforces the filter anyway; we just
        # enforce it.
        print(f"IssuerCNFilter enabled: {config.issuer_cn_filters()}",
              file=sys.stderr)

    run_stage = {"stage": "init"}
    sink, model = build_sink(config, device=device, database=database,
                             backend=_backend)

    # Filter emission: the capture and the artifact after every save.
    from ct_mapreduce_tpu_torch.filter import resolve_filter

    fknobs = resolve_filter(
        config.emit_filter or None, config.filter_path,
        config.filter_fp_rate, state_path=base_state_path,
        spill_dir=config.filter_capture_spill_dir,
        spill_mb=config.filter_capture_spill_mb,
        stream_chunk=config.filter_stream_chunk,
        fused_lanes=config.filter_fused_lanes,
        fmt=config.filter_format)
    emit_filter = fknobs.emit
    if fknobs.emit and model is not None:
        # Fleet workers get per-worker artifact and spill paths (like
        # their snapshots); the leader emits the MERGED fleet filter at
        # the unsuffixed path each epoch (leader_fleet_filter).
        model.aggregator.configure_filter_emission(
            worker_state_path(fknobs.path, fleet_worker_id, num_workers),
            fknobs.fp_rate,
            spill_dir=(worker_state_path(fknobs.spill_dir, fleet_worker_id,
                                         num_workers)
                       if fknobs.spill_dir else ""),
            spill_mem_bytes=fknobs.spill_mb << 20, fmt=fknobs.fmt,
            stream_chunk=fknobs.stream_chunk,
            fused_lanes=fknobs.fused_lanes)
    elif fknobs.emit:
        print("emitFilter ignored: filter emission needs backend = tpu",
              file=sys.stderr)
        emit_filter = False

    query_server = None
    fleet = None

    # Leader-side incremental build cache: across epoch ticks only the
    # churned groups of the merged fleet filter rebuild.
    from ct_mapreduce_tpu_torch.filter import GroupBuildCache

    fleet_filter_cache = GroupBuildCache()
    # The epoch ticks (fleet thread) and the end-of-run build (main
    # thread) share the cache and the artifact path.
    fleet_filter_lock = threading.Lock()

    def leader_fleet_filter(final: bool = False) -> None:
        """Leader epoch-tick duty: fold every worker snapshot present on
        disk (agg/merge.py) and emit the merged fleet filter, on the
        aggregator's device. Best-effort a tick: a worker mid-checkpoint
        contributes its previous snapshot; the next epoch catches up.
        The ``final`` build, after every worker's last save
        (``FleetService.finish``), raises what it meets: the run fails
        rather than leave a stale fleet filter behind."""
        if not emit_filter or num_workers <= 1:
            return
        if fleet is None or not fleet.is_leader:
            return
        from ct_mapreduce_tpu_torch.agg import merge as aggmerge
        from ct_mapreduce_tpu_torch.filter import artifact as fartifact
        from ct_mapreduce_tpu_torch.ops import bloom_cuda, sha256_cuda
        from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter

        paths = [
            p for p in (worker_state_path(base_state_path, w, num_workers)
                        for w in range(num_workers))
            if os.path.exists(p)
        ]
        if not paths:
            return
        with fleet_filter_lock:
            launched = (sha256_cuda.LAUNCHES, bloom_cuda.LAUNCHES)
            try:
                merged = aggmerge.load_checkpoints(paths)
                art = fartifact.build_from_merged(
                    merged, fp_rate=fknobs.fp_rate, allow_partial=True,
                    fmt=fknobs.fmt, cache=fleet_filter_cache,
                    device=model.aggregator.device)
                fartifact.write_artifact(fknobs.path, art.to_bytes())
                incr_counter("filter", "fleet_emit")
            except Exception as err:
                incr_counter("filter", "fleet_emit_error")
                print(f"fleet filter emission failed: "
                      f"{type(err).__name__}: {err}", file=sys.stderr)
                if final:
                    raise
                # The tick goes on: the next epoch retries the build.
            if final:
                print(f"fleet filter: {len(paths)} worker snapshot(s) "
                      f"folded into {fknobs.path} on "
                      f"{model.aggregator.device} (K1 "
                      f"{sha256_cuda.LAUNCHES - launched[0]}, K5 "
                      f"{bloom_cuda.LAUNCHES - launched[1]} launches)",
                      file=sys.stderr)

    def publish_distribution(epoch: int) -> None:
        """Every epoch tick, THIS worker publishes the artifact at the
        fleet's shared path (the leader's merged fleet filter) into its
        own distribution store. The bytes are the same on every worker,
        so every worker serves the same ETags, deltas and containers. A
        follower ticking before the leader's write lands publishes one
        epoch behind and catches up next tick."""
        if not emit_filter or query_server is None:
            return
        try:
            with open(fknobs.path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return  # the leader has not emitted yet; next epoch retries
        try:
            query_server.oracle.publish_artifact(epoch, blob,
                                                 source="fleet")
        except Exception as err:
            print(f"filter distribution publish failed: "
                  f"{type(err).__name__}: {err}", file=sys.stderr)

    def refresh_serve_filter() -> None:
        """Re-arm the query plane's filter tier from the live capture
        on the cadence the artifact is emitted (checkpoint time): the
        tier tracks the durable artifact, and between refreshes its
        registry-snapshot guard forwards anything newer to the table."""
        if query_server is not None and query_server.oracle.filter_first:
            try:
                query_server.oracle.refresh_filter()
            except Exception as err:
                # The run goes on: the tier keeps its last build and
                # the table answers what it cannot.
                print(f"filter tier refresh failed: "
                      f"{type(err).__name__}: {err}", file=sys.stderr)

    checkpoint_hook = None
    if model is not None and config.agg_state_path:
        # Snapshot device aggregates before every durable cursor write —
        # a crash must never leave the cursor ahead of aggregate state.
        def checkpoint_hook():
            sink.checkpointed_save(model.save)
            refresh_serve_filter()
    engine = LogSyncEngine(
        sink,
        database,
        num_threads=config.num_threads,
        offset=config.offset,
        limit=config.limit,
        save_period_s=parse_duration(config.save_period),
        checkpoint_hook=checkpoint_hook,
        # The device path streams whole responses to the native decoder.
        raw_batches=model is not None,
    )
    engine.start_store_threads()

    # Fleet lifecycle (ingest/fleet.py): leader election + start barrier
    # + heartbeats over the coordinator fabric, the leader publishing an
    # epoch every checkpointPeriod (each worker checkpoints aggregate
    # snapshot + cursors when it sees one), and a clean-shutdown
    # broadcast that stops every worker's downloaders.
    if num_workers > 1 or coord_backend or checkpoint_period:
        coordinator = build_coordinator(
            coord_backend, _cache, "ct-fetch", fleet_worker_id, num_workers)
        fleet = FleetService(
            coordinator,
            checkpoint_period_s=(parse_duration(checkpoint_period)
                                 if checkpoint_period else 0.0),
            on_checkpoint=lambda epoch: (engine.checkpoint_now(),
                                         leader_fleet_filter(),
                                         publish_distribution(epoch)),
            on_shutdown=lambda reason: (
                print(f"\nfleet shutdown broadcast: {reason}",
                      file=sys.stderr),
                engine.signal_stop(),
            ),
        )

    health = None
    if config.health_addr:
        try:
            health = HealthServer(
                engine, parse_duration(config.polling_delay_mean),
                addr=config.health_addr,
                verifier=getattr(sink, "verifier", None),
            )
            health.start()
        except OSError as err:
            print(f"health endpoint disabled: {err}", file=sys.stderr)
            health = None

    # Query plane: the batched membership-oracle JSON API over the live
    # aggregator. Device backend only: the per-entry database path has
    # no dedup table to serve.
    if config.query_port and model is not None:
        from ct_mapreduce_tpu_torch.serve.server import QueryServer

        try:
            query_server = QueryServer(
                model.aggregator, config.query_port,
                device=config.serve_device,
                replicas=config.serve_replicas,
                cache_size=config.serve_cache_size,
                # emitFilter also arms the filter-first tier and the
                # /filter routes (CTMR_SERVE_FILTER_FIRST can still
                # force either way).
                filter_first=(True if emit_filter else None),
                filter_fp_rate=fknobs.fp_rate,
                distrib_history=config.distrib_history,
                max_delta_chain=config.max_delta_chain).start()
            # A breach of the SLO rules flips /healthz to 503.
            query_server.slo_check = slo_breaches
            print(f"query endpoint: :{query_server.port}/query "
                  f"+ /issuer + /getcert + /filter "
                  f"(+ /filter/delta + /filter/container + "
                  f"/filter/manifest)", file=sys.stderr)
        except OSError as err:
            print(f"query endpoint disabled: {err}", file=sys.stderr)
            query_server = None
    elif config.query_port:
        print("queryPort ignored: the query plane needs backend = tpu",
              file=sys.stderr)

    def handle_signal(signum, frame):
        print(f"\nsignal {signum}: stopping after current batches...",
              file=sys.stderr)
        if signum == signal.SIGTERM:
            # Orchestrator kill: leave the post-mortem artifact before
            # draining (the drain itself may be what's wedged).
            flight.dump(f"signal {signum} (SIGTERM)")
        if fleet is not None and fleet.is_leader:
            # Leader-published clean shutdown: followers see the
            # broadcast and drain too, so one signal stops the fleet.
            fleet.request_shutdown(f"leader signal {signum}")
        engine.signal_stop()

    def handle_dump_signal(signum, frame):
        path = flight.dump(f"signal {signum} (SIGUSR1)")
        print(f"\nsignal {signum}: flight record "
              f"{path or 'not written'}", file=sys.stderr)

    # Previous handlers are restored in the finally below (main() must
    # leave no global hooks behind).
    prev_handlers = {}
    for signum, handler in ((signal.SIGINT, handle_signal),
                            (signal.SIGTERM, handle_signal),
                            (getattr(signal, "SIGUSR1", None),
                             handle_dump_signal)):
        if signum is None:
            continue
        try:
            prev_handlers[signum] = signal.signal(signum, handler)
        except (ValueError, OSError):
            pass  # not the main thread: the caller owns the signals

    printer = None
    if not config.nobars:
        printer = ProgressPrinter(
            engine, parse_duration(config.output_refresh_period)
        )
        printer.start()

    prof = None
    if config.profile_dir:
        try:
            prof = _start_profiler()
        except Exception as err:
            print(f"profiling disabled: {err}", file=sys.stderr)

    final_round_errors = False
    sync_round = 0
    try:
        if fleet is not None:
            # Election + start barrier: every worker begins its share at
            # once, as with the reference's Redis barrier.
            run_stage["stage"] = "electing"
            role = fleet.start(timeout_s=600.0, rejoin=resuming)
            print(f"fleet worker {fleet.worker_id}/{num_workers} "
                  f"({'leader' if role else 'follower'}"
                  f"{', rejoined' if fleet.rejoined else ''}, "
                  f"coordinator={type(fleet.coordinator).__name__})",
                  file=sys.stderr)
        while True:
            run_stage["stage"] = "syncing"
            # Dead-owner takeover on later runForever rounds (the start
            # barrier guaranteed full membership for round 0) and on a
            # rejoining worker's first round; the per-log lease
            # arbitrates the races.
            takeover = sync_round > 0 or (
                fleet is not None and fleet.rejoined)
            for url, f_off, f_lim, f_sfx in fleet_assignments(
                    fleet, log_urls, takeover=takeover,
                    errors=engine.errors):
                engine.sync_log(url, offset=f_off, limit=f_lim,
                                state_suffix=f_sfx)
            sync_round += 1
            engine.wait_for_downloads()
            run_stage["stage"] = "draining"
            engine.stop()  # drain queue, flush sink
            if model is not None:
                run_stage["stage"] = "saving"
                model.save()
                refresh_serve_filter()
            if fleet is not None:
                # This round's entries are durably folded: drop the
                # fetch leases so next round's rightful owners can take
                # them.
                fleet.release_claims()
            run_stage["stage"] = "idle"
            # Drain this round's errors so runForever doesn't re-print
            # (or unboundedly accumulate) them across polls.
            final_round_errors = bool(engine.errors)
            for e in engine.errors:
                print(f"error: {e}", file=sys.stderr)
            engine.errors.clear()
            if not config.run_forever or engine.stop_event.is_set():
                break
            if fleet is not None and fleet.shutdown_requested():
                break
            engine.start_store_threads()  # next round
            delay = polling_delay(
                parse_duration(config.polling_delay_mean),
                config.polling_delay_std_dev,
            )
            if engine.stop_event.wait(delay):
                break
        if fleet is not None and emit_filter and num_workers > 1:
            # The fleet's last merged filter holds every worker's final
            # save: each worker marks its own done, the leader waits for
            # the others (or for their heartbeats to lapse) and folds.
            run_stage["stage"] = "finishing"
            pending = fleet.finish(timeout_s=FLEET_FINISH_TIMEOUT_S)
            if pending:
                print(f"fleet filter: workers {pending} still running "
                      f"after {FLEET_FINISH_TIMEOUT_S:.0f} s; their last "
                      f"checkpoints are folded", file=sys.stderr)
            leader_fleet_filter(final=True)
        if hasattr(sink, "close"):
            sink.close()  # stops the overlap pipeline's threads
    except BaseException as err:
        # The post-mortem artifact for a crashing run: spans + metric
        # snapshots as of the moment the main loop died.
        flight.dump(f"unhandled exception in ct-fetch: {err!r}")
        raise
    finally:
        if prof is not None:
            try:
                path = _stop_profiler(prof, config.profile_dir)
                print(f"profile written to {path}", file=sys.stderr)
            except Exception as err:
                # Trace serialization failures must not mask the real
                # exception or skip the remaining shutdown steps.
                print(f"profiler stop failed: {err}", file=sys.stderr)
        run_stage["stage"] = "stopped"
        if printer:
            printer.stop()
        if health:
            health.stop()
        if query_server:
            query_server.stop()
        if fleet is not None:
            fleet.stop()
        if dumper:
            dumper.stop()
        if trace.enabled():
            path = trace.export()
            if path:
                print(f"trace written to {path}", file=sys.stderr)
        flight.uninstall()
        for signum, prev in prev_handlers.items():
            with contextlib.suppress(ValueError, OSError):
                signal.signal(signum, prev)
        engine.cleanup()
    return 1 if final_round_errors else 0


if __name__ == "__main__":
    sys.exit(main())
