"""Bootstrap wiring: choose backends and telemetry from configuration.

Reference: reference engine/engine.go — GetConfiguredStorage
(:19-48) picks local-disk iff certPath is set (else noop) and requires
the cache; PrepareTelemetry (:50-86) picks StatsD when configured, else
an in-memory sink with a periodic stderr dumper.

The TPU build generalizes the cache choice: `redisHost` selects the
Redis-parity fabric; otherwise an in-process MockRemoteCache serves
single-process runs (the on-device aggregate path needs no external
cache at all — see agg/aggregator.py).

A copy of ``ct_mapreduce_tpu.engine``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional

from ct_mapreduce_tpu_torch.config import CTConfig
from ct_mapreduce_tpu_torch.storage.certdb import FilesystemDatabase
from ct_mapreduce_tpu_torch.storage.interfaces import RemoteCache, StorageBackend
from ct_mapreduce_tpu_torch.storage.localdisk import LocalDiskBackend
from ct_mapreduce_tpu_torch.storage.mockcache import MockRemoteCache
from ct_mapreduce_tpu_torch.storage.noop import NoopBackend
from ct_mapreduce_tpu_torch.telemetry import flight, metrics
from ct_mapreduce_tpu_torch.telemetry.metrics import InMemSink, MetricsDumper, StatsdSink
from ct_mapreduce_tpu_torch.utils import parse_duration


def get_configured_storage(
    config: CTConfig,
) -> tuple[FilesystemDatabase, RemoteCache, StorageBackend]:
    """engine.go:19-48 analog."""
    if config.redis_host:
        from ct_mapreduce_tpu_torch.storage.rediscache import RedisCache

        cache: RemoteCache = RedisCache(
            config.redis_host, timeout_s=parse_duration(config.redis_timeout)
        )
    else:
        cache = MockRemoteCache()

    backend: StorageBackend
    if config.cert_path:
        backend = LocalDiskBackend(config.cert_path)
    else:
        backend = NoopBackend()

    database = FilesystemDatabase(backend, cache)
    return database, cache, backend


def prepare_telemetry(name: str, config: CTConfig) -> Optional[MetricsDumper]:
    """engine.go:50-86 analog; returns the dumper so callers can stop
    it on shutdown.

    Unlike the reference's either/or (StatsD XOR in-mem dumper), an
    ``InMemSink`` is ALWAYS the primary sink and StatsD — when
    configured — rides as a fanout emitter: ``MetricsDumper``, the
    Prometheus ``/metrics`` endpoint, and the flight recorder all need
    ``snapshot()``, which ``StatsdSink`` cannot provide. The dumper's
    periodic snapshots also feed the flight recorder's last-N ring
    (a no-op until ``flight.install`` runs)."""
    sink = InMemSink()
    if config.statsd_host and config.statsd_port:
        metrics.set_sink(
            sink,
            StatsdSink(config.statsd_host, config.statsd_port, f"{name}."),
        )
    else:
        metrics.set_sink(sink)
    dumper = MetricsDumper(
        sink,
        parse_duration(config.stats_refresh_period),
        on_snapshot=flight.record_snapshot,
    )
    dumper.start()
    return dumper
