"""Layered configuration: defaults < ini file < env vars.

A copy of the part of ``ct_mapreduce_tpu.config.config`` that the
port's ingest lanes, its sink and its checkpoints read. Directive names, defaults and
precedence are the JAX package's, which mirror the reference
(reference config/config.go:149-214): the ini section is consulted
first, an environment variable keyed by the directive name overrides
it, and the ``-config`` flag names the file (default ~/.ct-fetch.ini
when present, config.go:161-169).
"""

from __future__ import annotations

import argparse
import configparser
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class CTConfig:
    preparsed_ingest: bool = False  # host sidecar extraction + walker-free
    # device step; False (the default) runs the device DER walker
    log_expired_entries: bool = False
    issuer_cn_filter: str = ""
    batch_size: int = 65536
    table_bits: int = 22  # dedup table slots = 2**table_bits
    table_grow_at: float = 0.7  # grow-and-rehash load factor; 0 disables
    table_max_bits: int = 28  # growth ceiling; past it, spill to host lane
    mesh_shape: str = ""  # more than one device is not ported yet
    decode_workers: int = 0  # 0 = auto (cpu count); raw-batch decode pool
    decode_threads: int = 0  # 0 = auto; intra-chunk native decode threads
    device_queue_depth: int = 2  # sink steps in flight before a fold
    chunks_per_dispatch: int = 0  # K walker chunks per staged envelope;
    # 0 = CTMR_CHUNKS_PER_DISPATCH env, then 1 (per-chunk dispatch)
    staging_depth: int = 0  # staged envelopes in flight; 0 =
    # CTMR_STAGING_DEPTH env, then 2
    agg_state_path: str = ""  # .npz checkpoint of the aggregates
    checkpoint_mode: str = ""  # "ck01" full-only | "ck02" incremental
    # ("" = CTMR_CHECKPOINT_MODE env, then ck02)
    ckpt_max_chain: int = 0  # CTMRCK02 delta segments before a base
    # anchor (0 = CTMR_CKPT_MAX_CHAIN env, then 8)
    ckpt_segment_budget_mb: int = 0  # dirty-log cap per tick; beyond it
    # the save anchors (0 = CTMR_CKPT_SEGMENT_BUDGET_MB env, then 256)

    _DIRECTIVES = {
        # directive name -> (field, type)
        "preparsedIngest": ("preparsed_ingest", bool),
        "logExpiredEntries": ("log_expired_entries", bool),
        "issuerCNFilter": ("issuer_cn_filter", str),
        "batchSize": ("batch_size", int),
        "tableBits": ("table_bits", int),
        "tableGrowAt": ("table_grow_at", float),
        "tableMaxBits": ("table_max_bits", int),
        "meshShape": ("mesh_shape", str),
        "decodeWorkers": ("decode_workers", int),
        "decodeThreads": ("decode_threads", int),
        "deviceQueueDepth": ("device_queue_depth", int),
        "chunksPerDispatch": ("chunks_per_dispatch", int),
        "stagingDepth": ("staging_depth", int),
        "aggStatePath": ("agg_state_path", str),
        "checkpointMode": ("checkpoint_mode", str),
        "ckptMaxChain": ("ckpt_max_chain", int),
        "ckptSegmentBudgetMB": ("ckpt_segment_budget_mb", int),
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
        parser = argparse.ArgumentParser(add_help=False)
        parser.add_argument("-config", "--config", default="",
                            help="configuration .ini file")
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
        return cfg

    def issuer_cn_filters(self) -> list[str]:
        if not self.issuer_cn_filter:
            return []
        return self.issuer_cn_filter.split(",")
