"""Layered configuration: defaults < ini file < env vars < CLI flags.

A copy of ``ct_mapreduce_tpu.config.config`` (the port imports nothing
of the JAX package), so one ini drives either package. Directive names,
defaults, and precedence mirror the reference
(reference config/config.go:149-214): the ini section is consulted
first, an environment variable keyed by the directive name overrides
it, and a handful of CLI flags (-config, -offset, -limit,
-outputRefreshPeriod) override everything. The default config file is
~/.ct-fetch.ini when present (config.go:161-169).

The device directives keep the JAX package's names and values:
``backend = tpu`` selects the device pipeline, which in this port runs
on CUDA; ``batchSize`` / ``meshShape`` / ``tableBits`` size it.
Directives whose subsystem the port does not have yet parse here all
the same; ct-fetch refuses them with the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import configparser
import os
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Optional


@dataclass
class CTConfig:
    # Reference directives (config.go:184-202)
    offset: int = 0
    limit: int = 0
    log_url_list: str = ""  # "logList"
    num_threads: int = 1
    decode_workers: int = 0  # 0 = auto (cpu count); raw-batch decode pool
    decode_threads: int = 0  # 0 = auto; intra-chunk native decode threads
    # (the persistent C++ worker pool; CTMR_DECODE_THREADS equivalent)
    overlap_workers: int = 0  # >0 = overlapped ingest (decode‖device‖drain)
    preparsed_ingest: bool = False  # host sidecar extraction + walker-free
    # device step (CTMR_PREPARSED=1 equivalent; needs the native decoder)
    log_expired_entries: bool = False
    run_forever: bool = False
    polling_delay_mean: str = "10m"
    polling_delay_std_dev: int = 10
    save_period: str = "15m"
    issuer_cn_filter: str = ""
    cert_path: str = ""
    google_project_id: str = ""
    redis_host: str = ""
    redis_timeout: str = "5s"
    output_refresh_period: str = "125ms"
    stats_refresh_period: str = "10m"
    statsd_host: str = ""
    statsd_port: int = 0
    health_addr: str = ":8080"
    nobars: bool = False
    # Device-pipeline additions (the JAX package's names)
    backend: str = ""  # "", noop, localdisk, redis, tpu
    batch_size: int = 65536
    table_bits: int = 22  # dedup table slots = 2**table_bits per shard
    table_grow_at: float = 0.7  # grow-and-rehash load factor; 0 disables
    table_max_bits: int = 28  # growth ceiling; past it, spill to host lane
    mesh_shape: str = ""  # e.g. "data:4,expert:2"; empty = all devices on data
    device_queue_depth: int = 2
    chunks_per_dispatch: int = 0  # K walker chunks per resident device
    # envelope (staged device queue); 0 = CTMR_CHUNKS_PER_DISPATCH env,
    # then 1 (legacy per-chunk dispatch)
    staging_depth: int = 0  # staged envelopes in flight before the
    # submit side blocks (H2D double-buffer depth); 0 =
    # CTMR_STAGING_DEPTH env, then 2
    agg_state_path: str = ""  # .npz snapshot of device aggregates (tpu backend)
    profile_dir: str = ""  # torch.profiler trace output dir (empty = off)
    trace_path: str = ""  # Chrome trace-event JSON of the ingest spans
    # (telemetry/trace.py; CTMR_TRACE env equivalent; empty = off)
    metrics_port: int = 0  # Prometheus /metrics + /healthz HTTP port
    # (telemetry/promhttp.py; 0 = off)
    query_port: int = 0  # batched membership-oracle JSON API port
    # (serve/server.py; 0 = off; tpu backend only)
    serve_replicas: int = 0  # epoch-pinned snapshot replicas in the
    # query plane's pool (0 = CTMR_SERVE_REPLICAS env, then 2)
    serve_device: bool = True  # serve membership from pinned device
    # copies (jitted contains); host-numpy fallback when no copy pins
    serve_cache_size: int = 0  # hot-serial result cache entries
    # (0 = CTMR_SERVE_CACHE_SIZE env, then 4096; -1 disables)
    verify_signatures: bool = False  # batched on-device SCT/ECDSA
    # verification lane (CTMR_VERIFY=1 equivalent; tpu backend only)
    verify_log_keys: str = ""  # JSON file of trusted log keys for the
    # verify lane (CTMR_VERIFY_KEYS equivalent; empty = no keys →
    # every SCT counts as verify.no_key)
    verify_precomp_window: int = -1  # windowed-precompute ladder width
    # in bits for the verify kernels (-1 = unset →
    # CTMR_VERIFY_PRECOMP_WINDOW env, then 8; 0 is a REAL value — the
    # legacy Jacobian ladder — so an explicit 0 beats a stray env)
    verify_qtable_size: int = 0  # per-curve device-resident per-log-
    # key Q-table LRU slots (0 = CTMR_VERIFY_QTABLE_SIZE env, then 32)
    num_workers: int = 0  # fleet size: logs partition across this many
    # ct-fetch workers by rendezvous hash (0 = CTMR_NUM_WORKERS env,
    # then 1 = single-worker)
    worker_id: int = -1  # this worker's id in [0, numWorkers)
    # (-1 = unset → CTMR_WORKER_ID env, then 0; 0 is a REAL id, so an
    # explicit workerId = 0 beats a stray env value)
    checkpoint_period: str = ""  # leader-published checkpoint cadence
    # (durable aggregate snapshot + cursors on every epoch tick;
    # "" = CTMR_CHECKPOINT_PERIOD env, then no fleet cadence — the
    # per-log savePeriod ticker still runs)
    coordinator_backend: str = ""  # fleet coordination fabric:
    # redis | jax | solo ("" = CTMR_COORDINATOR env, then redis when
    # numWorkers > 1, else solo)
    emit_filter: bool = False  # compile crlite-style filter artifacts
    # from the aggregation state at checkpoint time (CTMR_EMIT_FILTER
    # equivalent; tpu backend only)
    filter_path: str = ""  # filter artifact output path
    # ("" = CTMR_FILTER_PATH env, then <aggStatePath>.filter)
    filter_fp_rate: float = 0.0  # target layer-0 false-positive rate
    # (0 = CTMR_FILTER_FP_RATE env, then 0.01)
    filter_capture_spill_dir: str = ""  # spill-ring directory bounding
    # filter-capture RSS ("" = CTMR_FILTER_SPILL_DIR env, then
    # in-memory capture)
    filter_capture_spill_mb: int = 0  # capture memory tier in MB before
    # a spill flush (0 = CTMR_FILTER_SPILL_MB env, then 256)
    filter_stream_chunk: int = 0  # serials per streamed key block of
    # the filter build (0 = CTMR_FILTER_STREAM_CHUNK env, then 2^16)
    filter_fused_lanes: int = 0  # lanes per fused filter-build scatter
    # dispatch (0 = CTMR_FILTER_FUSED_LANES env, then 2^20)
    filter_format: str = ""  # artifact format, "fl01" | "fl02"
    # ("" = CTMR_FILTER_FORMAT env, then fl02)
    platform_profile: str = ""  # tuned-knob profile JSON (one loader
    # for every subsystem's resolve_*; "" = CTMR_PLATFORM_PROFILE env)
    distrib_history: int = 0  # filter-distribution epochs held per
    # worker (0 = CTMR_DISTRIB_HISTORY env, then 8)
    max_delta_chain: int = 0  # delta links before a mandatory full-
    # snapshot anchor (0 = CTMR_MAX_DELTA_CHAIN env, then 4)
    checkpoint_mode: str = ""  # "ck01" full-only | "ck02" incremental
    # ("" = CTMR_CHECKPOINT_MODE env, then ck02)
    ckpt_max_chain: int = 0  # CTMRCK02 delta segments before a
    # mandatory base anchor (0 = CTMR_CKPT_MAX_CHAIN env, then 8)
    ckpt_segment_budget_mb: int = 0  # dirty-log cap per tick; beyond
    # it the save anchors (0 = CTMR_CKPT_SEGMENT_BUDGET_MB, then 256)
    fleet_metrics: Optional[bool] = None  # publish this worker's
    # metrics snapshot through the coordinator fabric each heartbeat
    # and serve /metrics/fleet + /healthz/fleet (unset =
    # CTMR_FLEET_METRICS env, then on)
    slo_max_ingest_lag: int = 0  # SLO: max entries between the ingest
    # cursor and the STH tree head before /healthz degrades
    # (0 = CTMR_SLO_MAX_INGEST_LAG env, then disabled)
    slo_max_checkpoint_age: float = 0.0  # SLO: max seconds since the
    # last durable checkpoint, graded against max(this,
    # checkpointPeriod) (0 = CTMR_SLO_MAX_CKPT_AGE_S, then disabled)
    slo_max_filter_lag: int = 0  # SLO: max epochs the published filter
    # may trail the checkpoint epoch (0 = CTMR_SLO_MAX_FILTER_LAG env,
    # then disabled)
    slo_max_serve_p99_ms: float = 0.0  # SLO: max span-derived serve
    # p99 in ms (0 = CTMR_SLO_MAX_SERVE_P99_MS env, then disabled)
    audit_log_list: str = ""  # log-list v3 JSON path for the audit
    # subsystem ("" = CTMR_AUDIT_LOG_LIST env, then unset)
    audit_quarantine_dir: str = ""  # durable divergence spool ("" =
    # CTMR_AUDIT_QUARANTINE_DIR env, then in-memory only)
    verbosity: int = 0  # glog-style -v level (flag only, not a directive)

    _DIRECTIVES = {
        # directive name -> (field, type)
        "offset": ("offset", int),
        "limit": ("limit", int),
        "logList": ("log_url_list", str),
        "numThreads": ("num_threads", int),
        "decodeWorkers": ("decode_workers", int),
        "decodeThreads": ("decode_threads", int),
        "overlapWorkers": ("overlap_workers", int),
        "preparsedIngest": ("preparsed_ingest", bool),
        "logExpiredEntries": ("log_expired_entries", bool),
        "runForever": ("run_forever", bool),
        "pollingDelayMean": ("polling_delay_mean", str),
        "pollingDelayStdDev": ("polling_delay_std_dev", int),
        "savePeriod": ("save_period", str),
        "issuerCNFilter": ("issuer_cn_filter", str),
        "certPath": ("cert_path", str),
        "googleProjectId": ("google_project_id", str),
        "redisHost": ("redis_host", str),
        "redisTimeout": ("redis_timeout", str),
        "outputRefreshPeriod": ("output_refresh_period", str),
        "statsRefreshPeriod": ("stats_refresh_period", str),
        "statsdHost": ("statsd_host", str),
        "statsdPort": ("statsd_port", int),
        "healthAddr": ("health_addr", str),
        "backend": ("backend", str),
        "batchSize": ("batch_size", int),
        "tableBits": ("table_bits", int),
        "tableGrowAt": ("table_grow_at", float),
        "tableMaxBits": ("table_max_bits", int),
        "meshShape": ("mesh_shape", str),
        "deviceQueueDepth": ("device_queue_depth", int),
        "chunksPerDispatch": ("chunks_per_dispatch", int),
        "stagingDepth": ("staging_depth", int),
        "aggStatePath": ("agg_state_path", str),
        "profileDir": ("profile_dir", str),
        "tracePath": ("trace_path", str),
        "metricsPort": ("metrics_port", int),
        "queryPort": ("query_port", int),
        "serveReplicas": ("serve_replicas", int),
        "serveDevice": ("serve_device", bool),
        "serveCacheSize": ("serve_cache_size", int),
        "verifySignatures": ("verify_signatures", bool),
        "verifyLogKeys": ("verify_log_keys", str),
        "verifyPrecompWindow": ("verify_precomp_window", int),
        "verifyQTableSize": ("verify_qtable_size", int),
        "numWorkers": ("num_workers", int),
        "workerId": ("worker_id", int),
        "checkpointPeriod": ("checkpoint_period", str),
        "coordinatorBackend": ("coordinator_backend", str),
        "emitFilter": ("emit_filter", bool),
        "filterPath": ("filter_path", str),
        "filterFpRate": ("filter_fp_rate", float),
        "filterCaptureSpillDir": ("filter_capture_spill_dir", str),
        "filterCaptureSpillMB": ("filter_capture_spill_mb", int),
        "filterStreamChunk": ("filter_stream_chunk", int),
        "filterFusedLanes": ("filter_fused_lanes", int),
        "filterFormat": ("filter_format", str),
        "platformProfile": ("platform_profile", str),
        "distribHistory": ("distrib_history", int),
        "maxDeltaChain": ("max_delta_chain", int),
        "checkpointMode": ("checkpoint_mode", str),
        "ckptMaxChain": ("ckpt_max_chain", int),
        "ckptSegmentBudgetMB": ("ckpt_segment_budget_mb", int),
        "fleetMetrics": ("fleet_metrics", bool),
        "sloMaxIngestLag": ("slo_max_ingest_lag", int),
        "sloMaxCheckpointAge": ("slo_max_checkpoint_age", float),
        "sloMaxFilterLag": ("slo_max_filter_lag", int),
        "sloMaxServeP99Ms": ("slo_max_serve_p99_ms", float),
        "auditLogList": ("audit_log_list", str),
        "auditQuarantineDir": ("audit_quarantine_dir", str),
    }

    @classmethod
    def load(
        cls,
        argv: Optional[list[str]] = None,
        env: Optional[dict[str, str]] = None,
        default_ini: Optional[str] = None,
    ) -> "CTConfig":
        """Build a config from CLI argv (default: sys.argv[1:]) with the
        reference's layering."""
        env = os.environ if env is None else env
        parser = cls.arg_parser()
        args, _ = parser.parse_known_args(argv)

        cfg = cls()

        ini_path = args.config
        if not ini_path:
            if default_ini is not None:
                candidate = default_ini
            else:
                candidate = str(Path.home() / ".ct-fetch.ini")
            if os.path.exists(candidate):
                ini_path = candidate

        section = None
        if ini_path and os.path.exists(ini_path):
            parsed = configparser.ConfigParser()
            # Reference ini files use a top-level (unnamed) section; feed
            # configparser a synthetic [DEFAULT] header.
            with open(ini_path) as fh:
                content = fh.read()
            if not content.lstrip().startswith("["):
                content = "[DEFAULT]\n" + content
            parsed.read_string(content)
            section = parsed["DEFAULT"] if "DEFAULT" in parsed else None
            if section is None and parsed.sections():
                section = parsed[parsed.sections()[0]]

        def apply(field_name: str, typ, value: str) -> bool:
            try:
                if typ is bool:
                    v = value.strip().lower()
                    if v in ("1", "t", "true"):
                        parsed = True
                    elif v in ("0", "f", "false"):
                        parsed = False
                    else:  # Go strconv.ParseBool errors on anything else
                        return False
                else:
                    parsed = typ(value)
            except (TypeError, ValueError):
                return False  # unparseable values are ignored (config.go:41-60)
            setattr(cfg, field_name, parsed)
            return True

        for directive, (field_name, typ) in cls._DIRECTIVES.items():
            # Env beats file, but only when it parses — an unparseable
            # env var falls back to the file value (config.go:41-123).
            if directive in env and apply(field_name, typ, env[directive]):
                continue
            if section is not None and directive in section:
                apply(field_name, typ, section[directive])

        # CLI flags override everything (config.go:204-213)
        if args.offset:
            cfg.offset = args.offset
        if args.limit:
            cfg.limit = args.limit
        if args.outputRefreshPeriod != "125ms":
            cfg.output_refresh_period = args.outputRefreshPeriod
        if args.nobars:
            cfg.nobars = True
        if getattr(args, "backend", None):
            cfg.backend = args.backend
        cfg.verbosity = args.v
        return cfg

    @staticmethod
    def arg_parser() -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("-config", "--config", default="", help="configuration .ini file")
        p.add_argument("-offset", "--offset", type=int, default=0, help="offset from the beginning")
        p.add_argument("-limit", "--limit", type=int, default=0, help="limit processing to this many entries")
        p.add_argument(
            "-outputRefreshPeriod",
            "--outputRefreshPeriod",
            default="125ms",
            help="Speed for refreshing progress",
        )
        p.add_argument("-nobars", "--nobars", action="store_true", help="disable display of download bars")
        p.add_argument(
            "-backend",
            "--backend",
            default="",
            help="storage execution path: noop | localdisk | redis | tpu",
        )
        p.add_argument(
            "-v", "--v",
            # glog-style "-v=2" arrives from argparse as "=2" — accept it.
            type=lambda s: int(s.lstrip("=")),
            default=0,
            help="verbosity level (glog-style)",
        )
        return p

    def usage(self) -> str:
        """Self-documenting directive listing (config.go:216-244)."""
        lines = [
            "Environment variable or config file directives:",
            "",
            "Choose at most one backing store:",
            "certPath = Path under which to store full DER-encoded certificates",
            "",
            "The external data cache:",
            "redisHost = address:port of the Redis instance",
            "",
            "Options:",
            "issuerCNFilter = Prefixes to match for CNs for permitted issuers, comma delimited",
            "runForever = Run forever, pausing `pollingDelay` between runs",
            "pollingDelayMean = Wait a mean of this long between polls",
            "pollingDelayStdDev = Use this standard deviation between polls",
            "logExpiredEntries = Add expired entries to the database",
            "numThreads = Use this many threads for normal operations",
            "decodeWorkers = native leaf-decode threads (0 = cpu count)",
            "decodeThreads = intra-chunk native decode/sidecar threads "
            "(0 = CTMR_DECODE_THREADS, then cpu count; workers x threads "
            "should stay <= host cores)",
            "overlapWorkers = overlapped-ingest decode pool size (0 = serial dispatch)",
            "preparsedIngest = host sidecar extraction + walker-free device step",
            "savePeriod = Duration between state saves, e.g. 15m",
            "logList = URLs of the CT Logs, comma delimited",
            "outputRefreshPeriod = Period between output publications",
            "statsRefreshPeriod = Period between stats dumps to stderr",
            "statsdHost = host for StatsD information",
            "statsdPort = port for StatsD information",
            "redisTimeout = Timeout for operations from Redis, e.g. 10s",
            "healthAddr = Address for the /health http endpoint",
            "",
            "Device execution (backend = tpu: the device pipeline):",
            "backend = noop | localdisk | redis | tpu",
            "batchSize = device batch size (entries per dispatch)",
            "tableBits = log2 of dedup-table slots per shard",
            "tableGrowAt = load factor that triggers grow-and-rehash (0 disables)",
            "tableMaxBits = log2 growth ceiling; beyond it lanes spill to the exact host lane",
            "meshShape = device mesh, e.g. data:4,expert:2",
            "deviceQueueDepth = host->device prefetch depth",
            "chunksPerDispatch = walker chunks fused into one resident "
            "device envelope (staged device queue; 1 = per-chunk "
            "dispatch, CTMR_CHUNKS_PER_DISPATCH equivalent)",
            "stagingDepth = staged envelopes in flight before the "
            "submit side blocks (H2D double-buffer depth, "
            "CTMR_STAGING_DEPTH equivalent)",
            "aggStatePath = Path for the on-device aggregate snapshot (.npz)",
            "profileDir = Write a torch.profiler trace of the run here",
            "tracePath = Write a Chrome trace-event JSON of the ingest "
            "spans here (CTMR_TRACE env equivalent)",
            "metricsPort = Serve Prometheus /metrics and /healthz on "
            "this port (0 disables)",
            "queryPort = Serve the batched membership-oracle JSON API "
            "(/query, /issuer, /getcert) on this port (0 disables)",
            "serveReplicas = epoch-pinned snapshot replicas in the "
            "query plane's pool (0 = CTMR_SERVE_REPLICAS, then 2; "
            "staggered refresh, round-robin serving)",
            "serveDevice = serve membership from pinned device copies "
            "via the jitted contains kernels (host-numpy fallback when "
            "no copy can pin; false forces the host mirror)",
            "serveCacheSize = hot-serial result cache entries in front "
            "of the batcher (0 = CTMR_SERVE_CACHE_SIZE, then 4096; "
            "-1 disables)",
            "verifySignatures = batched on-device SCT/ECDSA-P256 "
            "verification lane with pure-python host fallback "
            "(CTMR_VERIFY equivalent; per-issuer verified/failed "
            "counts in reports and /issuer)",
            "verifyLogKeys = JSON file of trusted CT log keys for the "
            "verify lane (CTMR_VERIFY_KEYS equivalent)",
            "verifyPrecompWindow = window width in bits for the "
            "verify kernels' precomputed-table ladders "
            "(CTMR_VERIFY_PRECOMP_WINDOW equivalent; default 8; an "
            "explicit 0 pins the legacy per-bit Jacobian ladder even "
            "when the env var is set)",
            "verifyQTableSize = per-curve device-resident per-log-key "
            "Q-table LRU slots for the windowed verify kernels "
            "(CTMR_VERIFY_QTABLE_SIZE equivalent; default 32 — size "
            "it at or above the live log-key count so steady state "
            "is 100% verify.qtable_hits)",
            "numWorkers = ingest fleet size: CT logs partition across "
            "this many workers by rendezvous hash; a single-log fleet "
            "stripes the entry-index space (CTMR_NUM_WORKERS "
            "equivalent)",
            "workerId = this worker's id in [0, numWorkers) "
            "(CTMR_WORKER_ID equivalent; an explicit 0 pins worker 0 "
            "even when the env var is set)",
            "checkpointPeriod = leader-published checkpoint cadence: "
            "every tick, each worker snapshots aggregates + cursors "
            "atomically for warm restart (CTMR_CHECKPOINT_PERIOD "
            "equivalent)",
            "coordinatorBackend = fleet coordination fabric: redis | "
            "jax | solo (CTMR_COORDINATOR equivalent; default redis "
            "when numWorkers > 1)",
            "emitFilter = compile a crlite-style filter-cascade "
            "artifact from the per-(issuer, expDate) known-serial "
            "sets on every checkpoint save (CTMR_EMIT_FILTER "
            "equivalent; a fleet leader also emits the merged fleet "
            "filter each epoch)",
            "filterPath = filter artifact output path "
            "(CTMR_FILTER_PATH equivalent; default "
            "<aggStatePath>.filter, per-worker suffixed in a fleet)",
            "filterFpRate = target layer-0 false-positive rate of the "
            "filter cascade (CTMR_FILTER_FP_RATE equivalent; default "
            "0.01; included serials are exact regardless)",
            "filterCaptureSpillDir = spill-ring directory for the "
            "filter capture: serial bytes overflow to durable segment "
            "files so capture RSS is bounded by filterCaptureSpillMB, "
            "not corpus size (CTMR_FILTER_SPILL_DIR equivalent; "
            "default in-memory capture; per-worker suffixed in a "
            "fleet; artifacts byte-identical either way)",
            "filterCaptureSpillMB = capture memory tier in MB before "
            "a spill flush (CTMR_FILTER_SPILL_MB equivalent; default "
            "256; only meaningful with filterCaptureSpillDir)",
            "filterStreamChunk = serials per streamed key block of "
            "the filter build (CTMR_FILTER_STREAM_CHUNK equivalent; "
            "default 2^16; bounds build transients, changes no bytes)",
            "filterFusedLanes = lanes per fused filter-build scatter "
            "dispatch (CTMR_FILTER_FUSED_LANES equivalent; default "
            "2^20; CTMR_FILTER_FUSED=0 forces the per-group build "
            "path — byte-identical)",
            "filterFormat = filter artifact format, fl01 | fl02 "
            "(CTMR_FILTER_FORMAT equivalent; default fl02 — per-group "
            "universes: decoupled deltas + dirty-group incremental "
            "rebuilds; fl01 is the global-universe compatibility path)",
            "platformProfile = tuned-knob profile JSON file "
            "(CTMR_PLATFORM_PROFILE equivalent): one loader feeds "
            "every subsystem's knob resolution, so a tuned device "
            "profile is a data file, not a code change — precedence "
            "explicit directive > CTMR_* env > profile > default",
            "distribHistory = filter-distribution epochs each worker "
            "holds for delta/conditional-GET serving "
            "(CTMR_DISTRIB_HISTORY equivalent; default 8)",
            "maxDeltaChain = delta links between mandatory full-"
            "snapshot anchors in the filter-distribution chain "
            "(CTMR_MAX_DELTA_CHAIN equivalent; default 4 — bounds a "
            "client's worst-case replay work)",
            "checkpointMode = aggregate-state checkpoint format: ck02 "
            "(default) appends O(churn) CTMRCK02 delta segments per "
            "epoch tick between full base anchors; ck01 writes the "
            "full .npz every tick (compatibility path and restore "
            "oracle) (CTMR_CHECKPOINT_MODE equivalent)",
            "ckptMaxChain = CTMRCK02 delta segments between mandatory "
            "base anchors (CTMR_CKPT_MAX_CHAIN equivalent; default 8 "
            "— bounds restore replay work)",
            "ckptSegmentBudgetMB = per-tick dirty-log budget; a tick "
            "whose churn exceeds it anchors with a full base instead "
            "(CTMR_CKPT_SEGMENT_BUDGET_MB equivalent; default 256)",
            "fleetMetrics = publish this worker's metrics snapshot "
            "through the coordinator fabric each heartbeat and serve "
            "the /metrics/fleet + /healthz/fleet fan-in "
            "(CTMR_FLEET_METRICS equivalent; default on — the payload "
            "rides a heartbeat already being sent)",
            "sloMaxIngestLag = degrade /healthz (HTTP 503) when any "
            "log's ingest cursor trails its STH tree head by more "
            "than this many entries (CTMR_SLO_MAX_INGEST_LAG "
            "equivalent; 0 = disabled)",
            "sloMaxCheckpointAge = degrade /healthz when the last "
            "durable checkpoint is older than this many seconds, "
            "graded against max(threshold, checkpointPeriod) so a "
            "threshold tighter than the cadence cannot flap "
            "(CTMR_SLO_MAX_CKPT_AGE_S equivalent; 0 = disabled)",
            "sloMaxFilterLag = degrade /healthz when the published "
            "filter epoch trails the checkpoint epoch by more than "
            "this many epochs (CTMR_SLO_MAX_FILTER_LAG equivalent; "
            "0 = disabled)",
            "sloMaxServeP99Ms = degrade /healthz when the span-"
            "derived serve p99 exceeds this many milliseconds "
            "(CTMR_SLO_MAX_SERVE_P99_MS equivalent; 0 = disabled)",
            "auditLogList = log-list v3 JSON (production Google/Apple "
            "schema) loaded as the audit subsystem's trust anchors "
            "(CTMR_AUDIT_LOG_LIST equivalent; unset = audit runs "
            "must name a list or use a recorded shard's embedded one)",
            "auditQuarantineDir = durable spool for native-vs-mirror "
            "divergence quarantine records (CTMR_AUDIT_QUARANTINE_DIR "
            "equivalent; unset = lanes are still excluded from "
            "aggregates, records stay in memory)",
        ]
        return "\n".join(lines)

    def log_urls(self) -> list[str]:
        return [u.strip() for u in self.log_url_list.split(",") if u.strip()]

    def issuer_cn_filters(self) -> list[str]:
        if not self.issuer_cn_filter:
            return []
        return self.issuer_cn_filter.split(",")
