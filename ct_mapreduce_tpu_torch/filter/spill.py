"""Memory-bounded filter capture: a spill-to-disk segment ring
(round 19, the ``filterCaptureSpillDir`` directive; a copy of
``ct_mapreduce_tpu.filter.spill``, which imports nothing of JAX).

The round-15 capture retains every first-seen serial's bytes in host
RAM for the life of the run — at 10⁸ serials that is tens of GB of
Python ``set`` overhead exactly where the build needs its arena. The
ring bounds it: serials accumulate in in-memory per-group sets until a
configured byte budget, then the WHOLE in-memory state flushes to one
append-only segment file and memory resets. Capture RSS is bounded by
the knob; corpus size only grows the spill directory.

Contracts:

- **Checkpoint/merge/npz unchanged.** The ring exposes the same
  ``items()`` surface the dict capture has (``[(key, set), ...]``,
  merged across memory + every segment, deduped by set semantics), so
  ``_write_npz``'s ``filter_keys``/``filter_vals`` arrays, the fleet
  merge, and ``build_from_aggregator`` are byte-identical to a dict
  capture of the same content. (Materializing a full ``items()`` view
  costs the corpus back — that is the existing npz contract, paid at
  checkpoint time, not for the life of the run.)
- **Crash-restart resume.** Each flush writes one complete segment
  atomically (tmp + rename + fsync). A restart pointed at the same
  directory picks every durable segment back up; serials that were
  only in memory are re-captured by the resume-at-cursor re-fold (the
  same idempotence the checkpoint tail replay relies on).
- **Determinism.** ``items()`` sorts keys and returns sets — what
  downstream writers serialize is a function of content only.
- **Content hashes (CTMRFL02 dirty tracking).** While the ring has
  never spilled (and found no pre-existing segments at construction),
  it maintains exact per-group XOR content hashes incrementally — the
  memory set IS the full logical content, so first-seen dedup is
  exact. The first flush permanently invalidates them: a serial
  re-captured after its set spilled looks new to the memory tier and
  would double-XOR. ``content_hashes()`` returns None once inexact —
  callers fall back to recomputation or full rebuild (a false MISS is
  a redundant rebuild; a false HIT would be a correctness bug, so the
  ring never guesses).

Record framing (one segment = magic + records until EOF): ``<iq I``
issuer_idx int32, exp_hour int64, serial length uint32, serial bytes.
A truncated tail record (crash mid-write of the non-atomic path never
happens — segments are atomic — but a torn filesystem is cheap to
tolerate) is dropped with a warning.
"""

from __future__ import annotations

import os
import struct
import sys
import tempfile

from ct_mapreduce_tpu_torch.telemetry.metrics import incr_counter, set_gauge

SEGMENT_MAGIC = b"CTMRSPL1"
_REC = struct.Struct("<iqI")
DEFAULT_MEM_BYTES = 256 << 20

# Per-serial bookkeeping estimate added to the raw byte length when
# charging the in-memory budget (bytes object + set slot overhead).
_SET_OVERHEAD = 64


class SpillCaptureRing:
    """Dict-capture drop-in with a byte-budgeted memory tier. Callers
    hold the aggregator's fold lock, exactly as for the dict."""

    def __init__(self, spill_dir: str,
                 mem_bytes: int = DEFAULT_MEM_BYTES):
        self.spill_dir = spill_dir
        self.mem_bytes = int(mem_bytes) if mem_bytes else DEFAULT_MEM_BYTES
        os.makedirs(spill_dir, exist_ok=True)
        self._mem: dict[tuple[int, int], set[bytes]] = {}
        self._mem_used = 0
        self.spilled_bytes = 0
        existing = self._segments()
        self._hashes: dict[tuple[int, int], int] = {}
        # Exact only while every captured serial is still in the memory
        # tier: pre-existing segments mean unknown prior content.
        self.hashes_exact = not existing
        self._next_seg = (max(
            (int(os.path.basename(p)[4:12]) for p in existing),
            default=-1) + 1)
        for p in existing:
            self.spilled_bytes += os.path.getsize(p)

    # -- capture surface (mirrors the dict) --------------------------
    def add(self, key: tuple[int, int], serial: bytes) -> None:
        s = self._mem.get(key)
        if s is None:
            s = self._mem[key] = set()
        if serial not in s:
            s.add(serial)
            if self.hashes_exact:
                from ct_mapreduce_tpu_torch.filter.cache import serial_hash

                self._hashes[key] = (
                    self._hashes.get(key, 0) ^ serial_hash(serial))
            self._mem_used += len(serial) + _SET_OVERHEAD
            if self._mem_used >= self.mem_bytes:
                self.flush()

    def update(self, key: tuple[int, int], serials) -> None:
        for sb in serials:
            self.add(key, sb)

    def items(self) -> list[tuple[tuple[int, int], set[bytes]]]:
        """Merged (memory + every segment) capture, keys sorted —
        the same shape ``dict.items()`` hands the checkpoint writer."""
        merged: dict[tuple[int, int], set[bytes]] = {}
        for key, serials in sorted(self._mem.items()):
            merged.setdefault(key, set()).update(serials)
        for path in self._segments():
            self._fold_segment(path, merged)
        return sorted(merged.items())

    def values(self):
        merged = self.items()  # already key-sorted
        return [s for _, s in merged]

    def __len__(self) -> int:
        return len(self.items())

    def __iter__(self):
        merged = self.items()  # already key-sorted
        return iter([k for k, _ in merged])

    # -- spill machinery ----------------------------------------------
    def _segments(self) -> list[str]:
        try:
            names = os.listdir(self.spill_dir)
        except OSError:
            return []
        return [os.path.join(self.spill_dir, n) for n in sorted(names)
                if n.startswith("seg-") and n.endswith(".spill")]

    def flush(self) -> None:
        """Durably spill the whole memory tier as one atomic segment."""
        if not self._mem:
            return
        fd, tmp = tempfile.mkstemp(prefix="seg.tmp.", dir=self.spill_dir)
        n_bytes = 0
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(SEGMENT_MAGIC)
                for key, serials in sorted(self._mem.items()):
                    idx, eh = key
                    for sb in sorted(serials):
                        fh.write(_REC.pack(int(idx), int(eh), len(sb)))
                        fh.write(sb)
                fh.flush()
                os.fsync(fh.fileno())
                n_bytes = fh.tell()
            final = os.path.join(self.spill_dir,
                                 f"seg-{self._next_seg:08d}.spill")
            os.replace(tmp, final)
        except BaseException:
            import contextlib

            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        self._next_seg += 1
        self._mem = {}
        self._mem_used = 0
        # Memory dedup no longer covers spilled serials — hashes can
        # never be trusted again for the life of this directory.
        self._hashes = {}
        self.hashes_exact = False
        self.spilled_bytes += n_bytes
        incr_counter("filter", "capture_spilled_bytes",
                     value=float(n_bytes))
        set_gauge("filter", "capture_spill_segments",
                  value=float(self._next_seg))

    def _fold_segment(self, path: str, merged: dict) -> None:
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as err:
            print(f"filter spill segment unreadable ({path}): {err}",
                  file=sys.stderr)
            return
        if blob[:8] != SEGMENT_MAGIC:
            print(f"filter spill segment bad magic ({path})",
                  file=sys.stderr)
            return
        pos = 8
        end = len(blob)
        while pos < end:
            if pos + _REC.size > end:
                print(f"filter spill segment truncated tail ({path})",
                      file=sys.stderr)
                break
            idx, eh, ln = _REC.unpack_from(blob, pos)
            pos += _REC.size
            if pos + ln > end:
                print(f"filter spill segment truncated tail ({path})",
                      file=sys.stderr)
                break
            merged.setdefault((idx, eh), set()).add(blob[pos: pos + ln])
            pos += ln

    def content_hashes(self) -> dict | None:
        """Exact per-group XOR content hashes ({(issuer_idx, expHour):
        int}) when the memory tier still holds the full capture; None
        once any spill (or a restart over prior segments) made them
        unverifiable."""
        if not self.hashes_exact:
            return None
        return dict(self._hashes)

    def stats(self) -> dict:
        return {
            "memBytes": self._mem_used,
            "memBudget": self.mem_bytes,
            "spilledBytes": self.spilled_bytes,
            "segments": len(self._segments()),
        }
