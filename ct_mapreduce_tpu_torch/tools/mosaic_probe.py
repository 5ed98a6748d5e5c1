"""The probe ladder toward the DER walker, on one CUDA card (port of
``tools/mosaic_probe.py``).

The JAX package's ladder bisected the TPU's Mosaic lowering of a Pallas
DER walker: ten kernels, each adding ONE construct on the road from an
elementwise add to a chained TLV walk on real certificates. Here the
ten stages are CUDA kernels (``csrc/mosaic_probe.cu``) built from the
walker kernel's own device functions (``csrc/der_walk.cuh``), so the
ladder still adds one construct at a time on the way to the walker.
Each stage has a plain PyTorch version, ported from the NumPy
references; stage 9 is also held to the host parser
(:mod:`ct_mapreduce_tpu_torch.core.der`) on 128 certificates.

Usage::

    python -m ct_mapreduce_tpu_torch.tools.mosaic_probe            # on the card
    python -m ct_mapreduce_tpu_torch.tools.mosaic_probe --device cpu

Prints one line per stage, PASS or FAIL, and a summary; on the card it
then times stage 9 at 2^20 lanes (8192 tiles of 128) with CUDA events
around back-to-back launches, queued while the card spins. Exit code 0 iff every stage passed.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ct_mapreduce_tpu_torch.ops import cuda_build
from ct_mapreduce_tpu_torch.tools.kernel_times import cuda_ms

LANES = 128  # one tile of lanes
WORDS = 64  # 256-byte rows, big-endian words
ROW_BYTES = WORDS * 4
WRAP = ROW_BYTES - 4
TIMED_TILES = 8192  # 2^20 lanes

STAGES = ("0-elementwise", "1-onehot-fixed", "2-onehot-dynamic",
          "3-fori-reads", "4-fori-masked-reduce", "5-uint32-reduce",
          "6-while-early-exit", "7-tlv-header", "8-tlv-walk",
          "9-serial-extract")
SERIAL_STAGE = 9

#: Kernel launches per stage made through :func:`run_stage`.
LAUNCHES = [0] * len(STAGES)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ctmr_probe_stage.restype = ctypes.c_int
    lib.ctmr_probe_stage.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.ctmr_probe_l2_fetch_granularity.restype = ctypes.c_int
    lib.ctmr_probe_l2_fetch_granularity.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.ctmr_probe_empty.restype = ctypes.c_int
    lib.ctmr_probe_empty.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


LIB = cuda_build.Library("mosaic_probe.cu", ("der_walk.cuh",), _bind)
build = LIB.build


def l2_fetch_granularity(device) -> int:
    """Bytes the card's L2 fetches from device memory at a time
    (``cudaLimitMaxL2FetchGranularity``), read, never set."""
    dev = torch.device(device)
    got = ctypes.c_longlong(0)
    cuda_build.raise_on(LIB.get().ctmr_probe_l2_fetch_granularity(
        dev.index or 0, ctypes.byref(got)), "the L2 fetch-size query")
    return int(got.value)


#: Stages 1 and 7 (``csrc/mosaic_probe.cu`` kWordLanes, kWordThreads):
#: consecutive lanes a thread, one 16-byte load and store, and threads a
#: block.
WORD_LANES = 4
WORD_THREADS = 256


def word_grid(lanes: int) -> tuple[int, int]:
    """(blocks, threads a block) that stages 1 and 7 launch over
    ``lanes`` lanes."""
    return -(-lanes // (WORD_THREADS * WORD_LANES)), WORD_THREADS


def empty_launch(blocks: int, threads: int, device) -> None:
    """Launch the library's empty kernel, ``blocks`` blocks of
    ``threads`` threads, on the current stream of CUDA ``device``: the
    fixed cost of a launch of that grid. Not a stage: not counted in
    LAUNCHES."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the empty launch needs a CUDA device, got {dev}")
    cuda_build.raise_on(LIB.get().ctmr_probe_empty(
        blocks, threads, dev.index or 0, cuda_build.stream_of(dev)),
        f"the empty kernel ({blocks} x {threads})")


# -- inputs --------------------------------------------------------------

def random_words(seed: int = 0, lanes: int = LANES) -> np.ndarray:
    """uint32[WORDS, lanes] random words (the original's ``_rows``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(WORDS, lanes), dtype=np.uint32)


def cert_words(lanes: int = LANES) -> tuple[np.ndarray, np.ndarray]:
    """One real certificate a lane, its first 256 bytes word-packed:
    (uint32[WORDS, lanes], int32[1, lanes] expected stage-9 checksum
    from the host parser). Serial contents of 1..20 bytes; every fourth
    serial has its high bit set, so DER adds a leading zero byte."""
    from ct_mapreduce_tpu_torch.core import der as hostder
    from ct_mapreduce_tpu_torch.utils import minicert

    words = np.zeros((WORDS, lanes), np.uint32)
    expected = np.zeros((lanes,), np.int32)
    for i in range(lanes):
        n = (i % 20) + 1
        first = (i % 19) + 1
        if i % 4 == 3 and n < 20:
            first |= 0x80
        serial = int.from_bytes(bytes([first]) * n, "big")
        der = minicert.make_cert(serial=serial, serial_len=None,
                                 subject_cn=f"probe{i}.example.com")
        row = np.frombuffer(der[:ROW_BYTES].ljust(ROW_BYTES, b"\0"), ">u4")
        words[:, i] = row
        f = hostder.parse_cert(der)
        expected[i] = sum(f.serial) + len(f.serial) * 1000
    return words, expected[None, :]


def crafted_serial_rows(seed: int = 0, copies: int = 4) -> np.ndarray:
    """uint32[WORDS, n] rows for stage 9's edges: headers in long form of
    1-3 length octets, a version whose content, or a serial header or
    serial whose bytes, run past the kernel's window (WINDOW_WORDS) and
    past the row's end, serials of length 0 and 255, a missing version, a
    serial tag that is not INTEGER. Each case ``copies`` times, the bytes
    after its headers random (from ``seed``)."""
    cases = [
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x14",
        b"\x30\x83\x01\x00\x00\x30\x81\xf0\xa0\x03\x02\x01\x02\x02\x10",
        b"\x30\x80\x30\x83\x01\x00\x00\xa0\x03\x02\x01\x02\x02\x08",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x20",  # serial header past
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x13",  # header at the edge
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x18",  # header across it
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x82\x01\x00",  # past the row
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x81\xf5",  # header at 253
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x1e",  # past
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x81\xff",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x82\x12\x34",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x80\x00\x30",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x00",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\x02\x10",  # no version
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x04\x10",
        b"\x30\x82\x01\x00\x30\x82\x00\xf0\xa0\x03\x02\x01\x02\x02\x83\x00\x10\x00",
        b"\x30\x81\xff\x30\x81\xfc\xa0\x03\x02\x01\x02\x02\x15",
    ]
    rng = np.random.default_rng(seed)
    rows = []
    for head in cases:
        for _ in range(copies):
            row = rng.integers(0, 256, ROW_BYTES, dtype=np.uint8)
            row[:len(head)] = np.frombuffer(head, np.uint8)
            rows.append(np.frombuffer(row.tobytes(), ">u4").astype(np.uint32))
    return np.stack(rows, 1)


#: Stage 9's window (``csrc/mosaic_probe.cu`` kWindowWords): the words of
#: a row each lane loads at once; a read past them goes to the row.
WINDOW_WORDS = 9


def serial_window_model(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NumPy model of stage 9's kernel over uint32[WORDS, n] words: its
    header reads of four bytes from the window (a funnel shift of two
    words) or, past it, byte by byte clipped into the row, and the
    serial's byte sum a masked word at a time. Returns (int32[1, n],
    bool[n] lanes that read past the window)."""
    w = np.asarray(words, np.uint32).astype(np.int64)
    n = w.shape[1]
    lanes = np.arange(n)
    win = w[:WINDOW_WORDS]
    past = np.zeros((n,), bool)

    def byte(q):
        qc = np.clip(q, 0, ROW_BYTES - 1)
        return (w[qc >> 2, lanes] >> ((3 - (qc & 3)) * 8)) & 0xFF

    def tlv(q):
        fast = (q >= 0) & (q + 3 < 4 * WINDOW_WORDS)
        k = np.clip(q >> 2, 0, WINDOW_WORDS - 1)
        sh = (q & 3) * 8
        v_win = ((win[k, lanes] << sh) | (
            win[np.minimum(k + 1, WINDOW_WORDS - 1), lanes] >> (32 - sh))) \
            & 0xFFFFFFFF
        v_row = ((byte(q) << 24) | (byte(q + 1) << 16) | (byte(q + 2) << 8)
                 | byte(q + 3))
        past[~fast] = True
        v = np.where(fast, v_win, v_row)
        l0, l1, l2 = (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF
        long_form = l0 >= 0x80
        nlen = np.where(long_form, l0 & 0x7F, 0)
        content = np.where(long_form,
                           np.where(nlen == 1, l1, (l1 << 8) | l2), l0)
        return v >> 24, 2 + nlen, content

    zero = np.zeros((n,), np.int64)
    _t0, h0, _c0 = tlv(zero)
    _t1, h1, _c1 = tlv(h0)
    el = h0 + h1
    tag_e, h_e, c_e = tlv(el)
    ser_el = np.where(tag_e == 0xA0, el + h_e + c_e, el)
    tag_s, h_s, c_s = tlv(ser_el)
    ser_off = ser_el + h_s
    lo = np.maximum(ser_off, 0)
    hi = np.minimum(ser_off + c_s, ROW_BYTES)
    total = zero.copy()
    for k in range(WORDS):
        on = (4 * k < hi) & (4 * k + 4 > lo)
        a = np.clip(lo - 4 * k, 0, 4)
        b = np.clip(hi - 4 * k, 0, 4)
        keep = ((0xFFFFFFFF >> (8 * a)) & ~(0xFFFFFFFF >> (8 * b))) \
            & 0xFFFFFFFF
        x = np.where(on, w[k] & keep, 0)
        total += (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + (x >> 24)
        if k >= WINDOW_WORDS:
            past |= on
    ok = tag_s == 0x02
    out = np.where(ok, total + c_s * 1000, 0).astype(np.int32)
    return out[None, :], past


#: Stage 3's reads (the original's ``fori_loop(0, 16, ...)``) and window
#: (``csrc/mosaic_probe.cu`` kForiWindowWords): the words of a row each
#: lane loads at once; a read past them goes to the row.
FORI_READS = 16
FORI_WINDOW_WORDS = 12


def fori_window_model(words: np.ndarray, window: int = FORI_WINDOW_WORDS
                      ) -> tuple[np.ndarray, np.ndarray]:
    """NumPy model of stage 3's kernel over uint32[WORDS, n] words: the
    16 chained byte reads, each from the lane's first ``window`` words
    (its window) or, past them, from the row. Returns (int32[1, n],
    bool[n] lanes that read at or past word ``window``)."""
    w = np.asarray(words, np.uint32).astype(np.int64)
    n = w.shape[1]
    lanes = np.arange(n)
    win = w[:window]
    off = np.zeros((n,), np.int64)
    acc = np.zeros((n,), np.int64)
    past = np.zeros((n,), bool)
    for _ in range(FORI_READS):
        k = off >> 2
        outside = k >= window
        past |= outside
        word = np.where(outside, w[k, lanes],
                        win[np.minimum(k, window - 1), lanes])
        byte = (word >> ((3 - (off & 3)) * 8)) & 0xFF
        off = (off + 1 + (byte & 3)) % WRAP
        acc += byte
    return acc.astype(np.int32)[None, :], past


def fori_reach_share(window: int) -> float:
    """The share of random rows whose stage-3 walk reads at or past word
    ``window``: the last of the 16 reads lies at the sum of 15 steps,
    each 1 + (a fresh random byte & 3), so uniform in 1..4."""
    p = np.array([1.0])
    for _ in range(FORI_READS - 1):
        p = np.convolve(p, [0.0, 0.25, 0.25, 0.25, 0.25])
    return float(p[4 * window:].sum())


def crafted_fori_rows(seed: int = 0, copies: int = 4) -> np.ndarray:
    """uint32[WORDS, n] rows for stage 3's edges: every byte 0xFF (steps
    of 4, the last read in word 15) or 0 (steps of 1, words 0-3), and a
    walk whose last read lands at each offset 15..60 (every word 3..15,
    each side of the window's end among them), its steps shuffled. Each
    case ``copies`` times, the bits a walk does not use random (from
    ``seed``)."""
    rng = np.random.default_rng(seed)
    rows = []

    def add(row):
        rows.append(np.frombuffer(row.tobytes(), ">u4").astype(np.uint32))

    for _ in range(copies):
        add(np.full(ROW_BYTES, 0xFF, np.uint8))
        add(np.zeros(ROW_BYTES, np.uint8))
    for last in range(FORI_READS - 1, 4 * (FORI_READS - 1) + 1):
        extra = last - (FORI_READS - 1)  # spread over 15 steps, 0-3 each
        base = np.array([min(3, max(0, extra - 3 * i))
                         for i in range(FORI_READS - 1)])
        for _ in range(copies):
            steps = 1 + rng.permutation(base)
            row = rng.integers(0, 256, ROW_BYTES, dtype=np.uint8)
            at = np.concatenate(([0], np.cumsum(steps)))
            row[at[:-1]] = (row[at[:-1]] & 0xFC) | (steps - 1)
            add(row)
    return np.stack(rows, 1)


def crafted_dyn_rows(seed: int = 0, copies: int = 1) -> np.ndarray:
    """uint32[WORDS, 256 * copies] rows for stage 2's edges: byte 0
    taking each of the 256 values, so the second read covers every word
    (248-251 in word 62) and the wrap of 252-255 to 0-3, which falls in
    word 0; the other bytes random (from ``seed``)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (WORDS, 256 * copies), dtype=np.uint32)
    top = np.tile(np.arange(256, dtype=np.uint32), copies)
    w[0] = (w[0] & 0x00FFFFFF) | (top << 24)
    return w


#: Stage 4's loop trips (the original's ``fori_loop(0, 8, ...)``).
MASKED_TRIPS = 8
#: Integer operations a word of stage 4's one-pass form: the shift to
#: (w >> 8), the multiply-high, its shift and the multiply-subtract of the
#: residue, the byte mask, the compare and select of the weight, the
#: multiply-add into the sum.
MASKED_OPS_PER_WORD = 8


def mod3_mulhi(x: np.ndarray) -> np.ndarray:
    """x % 3 of uint32 ``x`` as stage 4's kernel takes it: the quotient
    by a multiply-high with ceil(2^33 / 3) = 0xAAAAAAAB."""
    x = np.asarray(x, np.uint32).astype(np.uint64)
    return (x - 3 * ((x * 0xAAAAAAAB) >> 33)).astype(np.uint32)


def fori_masked_model(words: np.ndarray) -> np.ndarray:
    """NumPy model of stage 4's kernel over uint32[WORDS, n] words: one
    pass, each word's low byte weighed by the number of trips i in
    0..MASKED_TRIPS-1 with i % 3 equal to its (w >> 8) % 3 (3, 3, 2).
    int32[1, n]."""
    w = np.asarray(words, np.uint32)
    m = mod3_mulhi(w >> np.uint32(8)).astype(np.int64)
    weight = (MASKED_TRIPS + 2 - m) // 3
    total = ((w & 0xFF).astype(np.int64) * weight).sum(0)
    return total.astype(np.int32)[None, :]


def crafted_masked_rows(lanes: int = LANES) -> np.ndarray:
    """uint32[WORDS, lanes] rows for stage 4's edges, repeated to fill
    ``lanes``: every word 0xFFFFFFFF or 0; words whose (w >> 8) % 3 is 0,
    1 or 2, each with low byte 255 and with (w >> 8) at the top of the
    24-bit range; low bytes 255 everywhere over random high bits; and a
    row of each residue in turn."""
    rng = np.random.default_rng(4)
    top = (1 << 24) - 1  # (w >> 8) at its largest; 0xFFFFFF % 3 == 0
    cols = [np.full(WORDS, 0xFFFFFFFF), np.zeros(WORDS)]
    for m in range(3):
        cols.append(np.full(WORDS, (m << 8) | 0xFF))
        cols.append(np.full(WORDS, ((top - m) << 8) | 0xFF))
        cols.append(np.full(WORDS, (top - m) << 8))
    cols.append(rng.integers(0, 2**32, WORDS, dtype=np.uint64) | 0xFF)
    cols.append((np.arange(WORDS) % 3 << 8) | 0xFF)
    cols.append(((top - np.arange(WORDS) % 3) << 8) | 0xFF)
    rows = np.stack(cols, 1).astype(np.uint32)
    return np.tile(rows, (1, -(-lanes // len(cols))))[:, :lanes]


def crafted_tlv_rows(seed: int = 0, copies: int = 4) -> np.ndarray:
    """uint32[WORDS, n] rows for stage 8's edges: every byte 0xFF (long
    form, nlen 127, constructed) or 0; a first header whose content
    sends the walk to each offset 248-251, so the next 4-byte header
    read takes the row's last words, with a constructed or a
    primitive header there; the longest content (65,535, wrapping); the
    indefinite-length octet 0x80; chains of constructed tags in short
    and long form. Each case ``copies`` times, the bytes after its
    headers random (from ``seed``)."""
    rng = np.random.default_rng(seed)
    # (header bytes at 0, an offset, the bytes there)
    cases = [(b"\xff" * ROW_BYTES, 0, b""), (b"\x00" * ROW_BYTES, 0, b"")]
    for target in range(WRAP - 4, WRAP):
        for there in (b"\x30\x82\xff\xff", b"\x04\x81\xfe", b"\xff\xff\xff"):
            cases.append((b"\x04\x81" + bytes([target - 3]), target, there))
            cases.append((b"\x04\x82\x01" + bytes([target - 8]), target, there))
    cases += [(head, 0, b"") for head in (
        b"\x04\x82\xff\xff",
        b"\x30\x80\x30\x80\xa0\x80",
        b"\x30\x00" * (ROW_BYTES // 2),
        b"\x30\x81\x05" * (ROW_BYTES // 3),
        b"\xa0\x82\x01\x00" * (ROW_BYTES // 4),
        b"\x30\xff" + b"\x30\x01" * 127)]
    rows = []
    for head, q, there in cases:
        for _ in range(copies):
            row = rng.integers(0, 256, ROW_BYTES, dtype=np.uint8)
            row[:len(head)] = np.frombuffer(head, np.uint8)
            row[q:q + len(there)] = np.frombuffer(there, np.uint8)
            rows.append(np.frombuffer(row.tobytes(), ">u4").astype(np.uint32))
    return np.stack(rows, 1)


#: Bytes 2-3 of :func:`crafted_step_rows`' headers, one set of 256 rows
#: each.
STEP_TAILS = ((0x00, 0x00), (0x00, 0x01), (0x00, 0xFD), (0xFF, 0xFF),
              (0x01, 0x00))


def crafted_step_rows(seed: int = 0, copies: int = 1) -> np.ndarray:
    """uint32[WORDS, 1280 * copies] rows for stage 7's edges: the first
    length octet (byte 1) at each of its 256 values, with bytes 2-3 at
    each pair of STEP_TAILS. That covers the short form, 0x80 (count 0,
    two length bytes read), 0x81 (one), 0xFF (hdr 129), and ends below,
    at (0x80 with 00 FD: 2 + 253) and above the clip at 255. The tag and
    the other words are random (from ``seed``)."""
    rng = np.random.default_rng(seed)
    tails = np.repeat(np.array(STEP_TAILS, np.uint32), 256, axis=0)
    n = len(tails) * copies
    w = rng.integers(0, 2**32, (WORDS, n), dtype=np.uint32)
    l0 = np.tile(np.arange(256, dtype=np.uint32), len(STEP_TAILS) * copies)
    l12 = np.tile(tails, (copies, 1))
    w[0] = ((w[0] & np.uint32(0xFF000000)) | (l0 << np.uint32(16))
            | (l12[:, 0] << np.uint32(8)) | l12[:, 1])
    return w


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words → an int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        device)


def offset_tensor(words: np.ndarray, device, offset: int = 1
                  ) -> torch.Tensor:
    """``words`` as a contiguous int32 view that starts ``offset`` words
    into its buffer, so 4 * offset bytes past a 16-byte boundary for an
    offset of 1-3."""
    n = words.shape[1]
    buf = torch.empty(WORDS * n + offset, dtype=torch.int32, device=device)
    view = buf[offset:].view(WORDS, n)
    view.copy_(to_tensor(words, device))
    return view


# -- plain versions ------------------------------------------------------

class _Lanes:
    """Byte reads of lane-minor words; ``words_read`` records, when
    asked, which word of each lane each read fetched."""

    def __init__(self, w: torch.Tensor, record: bool = False) -> None:
        self.w = w.to(torch.int64) & 0xFFFFFFFF  # [WORDS, n]
        self.n = w.shape[1]
        self.words_read: list[torch.Tensor] | None = [] if record else None

    def read(self, off: torch.Tensor, clip: bool = False,
             live: torch.Tensor | None = None) -> torch.Tensor:
        if clip:
            off = off.clamp(0, ROW_BYTES - 1)
        inside = (off >= 0) & (off < ROW_BYTES)
        if live is not None:
            inside = inside & live
        widx = off.clamp(0, ROW_BYTES - 1) >> 2
        if self.words_read is not None:
            self.words_read.append(torch.where(inside, widx, -1))
        word = torch.gather(self.w, 0, widx[None, :])[0]
        return torch.where(inside, (word >> ((3 - (off & 3)) * 8)) & 0xFF, 0)

    def all_words(self) -> torch.Tensor:
        if self.words_read is not None:
            self.words_read.extend(
                torch.full((self.n,), k, device=self.w.device)
                for k in range(WORDS))
        return self.w


def _zeros(ln: _Lanes) -> torch.Tensor:
    return torch.zeros((ln.n,), dtype=torch.int64, device=ln.w.device)


def _tlv(ln: _Lanes, off: torch.Tensor, clip: bool):
    """The probe's TLV header at ``off`` → (tag, hdr, content)."""
    l0 = ln.read(off + 1, clip)
    long_form = l0 >= 0x80
    nlen = torch.where(long_form, l0 & 0x7F, 0)
    l1 = ln.read(off + 2, clip)
    l2 = ln.read(off + 3, clip)
    content = torch.where(long_form,
                          torch.where(nlen == 1, l1, l1 * 256 + l2), l0)
    return ln.read(off, clip), 2 + nlen, content


def _p_elementwise(ln):
    return (ln.all_words() & 0xFF).sum(0)


def _p_onehot_fixed(ln):
    return ln.read(torch.full((ln.n,), 17, device=ln.w.device))


def _p_onehot_dyn(ln):
    first = ln.read(_zeros(ln)) % WRAP  # the top byte of word 0
    return ln.read(first)


def _p_fori_reads(ln):
    off, acc = _zeros(ln), _zeros(ln)
    for _ in range(16):
        byte = ln.read(off)
        off = (off + 1 + (byte & 3)) % WRAP
        acc = acc + byte
    return acc


def _p_fori_masked(ln):
    w = ln.all_words()
    acc = _zeros(ln)
    for i in range(8):
        mask = (w >> 8) % 3 == i % 3
        acc = acc + torch.where(mask, w & 0xFF, 0).sum(0)
    return acc


def _p_while_early_exit(ln):
    off = _zeros(ln)
    done = torch.zeros((ln.n,), dtype=torch.bool, device=ln.w.device)
    for _ in range(32):
        if bool(done.all()):
            break
        byte = ln.read(off, live=~done)
        done = done | (byte == 0)
        off = torch.where(done, off, (off + 1) % WRAP)
    return off


def _p_tlv_step(ln):
    _tag, hdr, content = _tlv(ln, _zeros(ln), clip=True)
    return (hdr + content).clamp(0, ROW_BYTES - 1)


def _p_tlv_walk(ln):
    off, acc = _zeros(ln), _zeros(ln)
    for _ in range(12):
        tag, hdr, content = _tlv(ln, off, clip=True)
        constructed = (tag & 0x20) != 0
        off = torch.where(constructed, off + hdr, off + hdr + content) % WRAP
        acc = acc + tag
    return off + acc


def _p_serial_extract(ln):
    _t0, h0, _c0 = _tlv(ln, _zeros(ln), clip=True)
    tbs_off = h0
    _t1, h1, _c1 = _tlv(ln, tbs_off, clip=True)
    el = tbs_off + h1
    tag_e, h_e, c_e = _tlv(ln, el, clip=True)
    ser_el = torch.where(tag_e == 0xA0, el + h_e + c_e, el)
    tag_s, h_s, c_s = _tlv(ln, ser_el, clip=True)
    ser_off = ser_el + h_s
    total = _zeros(ln)
    for q in range(ROW_BYTES):
        q_t = torch.full((ln.n,), q, device=ln.w.device)
        inside = (q_t >= ser_off) & (q_t < ser_off + c_s)
        total = total + ln.read(q_t, live=inside)
    ok = (tag_s == 0x02).to(torch.int64)
    return total * ok + c_s * 1000 * ok


_PLAIN = (_p_elementwise, _p_onehot_fixed, _p_onehot_dyn, _p_fori_reads,
          _p_fori_masked, _p_elementwise, _p_while_early_exit, _p_tlv_step,
          _p_tlv_walk, _p_serial_extract)


def plain_stage(stage: int, words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of stage ``stage`` over int32[WORDS, n]
    words (uint32 bits): int32[1, n]."""
    return _PLAIN[stage](_Lanes(words)).to(torch.int32)[None, :]


def footprint(stage: int, words: torch.Tensor):
    """What each lane of a stage must read, counted with the plain
    version: ``(words, sectors, reads)``, int64[n] the distinct words it
    touches, float64[n] its share of the distinct 32-byte sectors (the
    distinct (word, lane // 8) pairs; a sector that j lanes touch counts
    1/j to each, so the shares sum to the sectors) and int64[n] the byte
    reads it makes."""
    ln = _Lanes(words, record=True)
    _PLAIN[stage](ln)
    idx = torch.stack(ln.words_read, 1)
    reads = (idx >= 0).sum(1)
    idx = idx.sort(dim=1).values
    new = torch.ones_like(idx, dtype=torch.bool)
    new[:, 1:] = idx[:, 1:] != idx[:, :-1]
    new &= idx >= 0
    lane = torch.arange(ln.n, device=idx.device)[:, None].expand_as(idx)[new]
    _keys, inv, lanes_on = torch.unique((lane // 8) * WORDS + idx[new],
                                        return_inverse=True, return_counts=True)
    share = torch.zeros((ln.n,), dtype=torch.float64, device=idx.device)
    share.index_add_(0, lane, 1.0 / lanes_on[inv].to(torch.float64))
    return new.sum(1), share, reads


# -- the kernels -----------------------------------------------------------

def kernel_stage(stage: int, words: torch.Tensor) -> torch.Tensor:
    """Launch stage ``stage`` on the current stream over contiguous CUDA
    int32[WORDS, n] words: int32[1, n]."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"the probe kernels need CUDA tensors, got {dev}")
    if not 0 <= stage < len(STAGES):
        raise ValueError(f"no probe stage {stage}")
    n = int(words.shape[1]) if words.dim() == 2 else -1
    cuda_build.check_tensor("words", words, torch.int32, (WORDS, n), dev)
    out = torch.empty((1, n), dtype=torch.int32, device=dev)
    if n:
        rc = LIB.get().ctmr_probe_stage(
            stage, words.data_ptr(), n, out.data_ptr(), dev.index or 0,
            cuda_build.stream_of(dev))
        cuda_build.raise_on(rc, f"probe stage {stage}")
        LAUNCHES[stage] += 1
    return out


def run_stage(stage: int, words: torch.Tensor) -> torch.Tensor:
    """Stage ``stage`` on the words' device: the kernel on CUDA tensors,
    the plain version on CPU tensors, no fallback between them."""
    if words.device.type == "cuda":
        return kernel_stage(stage, words)
    if words.device.type == "cpu":
        return plain_stage(stage, words)
    raise ValueError(f"no probe path for device {words.device}")


def stage_inputs(stage: int, lanes: int = LANES, seed: int = 0):
    """(words, expected or None) of a stage: random words, or real
    certificates with the host parser's checksum for stage 9 (tiled to
    ``lanes``)."""
    if stage != SERIAL_STAGE:
        return random_words(seed, lanes), None
    words, expected = cert_words(LANES)
    reps = -(-lanes // LANES)
    return (np.tile(words, (1, reps))[:, :lanes],
            np.tile(expected, (1, reps))[:, :lanes])


def run_ladder(device, log=print) -> list[bool]:
    """Every stage on ``device`` against its plain version on the CPU
    (and stage 9 against the host parser); one PASS/FAIL line each."""
    passed = []
    for stage, name in enumerate(STAGES):
        words, expected = stage_inputs(stage)
        got = run_stage(stage, to_tensor(words, device)).cpu()
        want = plain_stage(stage, to_tensor(words, "cpu"))
        ok = torch.equal(got, want)
        msg = "equal to the plain version" if ok else "differs from the plain version"
        if ok and expected is not None:
            ok = np.array_equal(got.numpy(), expected)
            msg += (", equal to the host parser" if ok
                    else ", differs from the host parser")
        log(f"{'PASS' if ok else 'FAIL'} {name}: {msg}")
        passed.append(ok)
    return passed


def time_stage(stage: int, words: torch.Tensor, reps: int = 25,
               calls: int = 20) -> list[float]:
    """Milliseconds per launch of a stage kernel (:func:`cuda_ms`)."""
    return cuda_ms(lambda: kernel_stage(stage, words), reps, calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu for the plain versions",
              file=sys.stderr)
        return 2
    passed = run_ladder(device)
    failures = [name for name, ok in zip(STAGES, passed) if not ok]
    print(f"{len(STAGES) - len(failures)}/{len(STAGES)} stages passed"
          + (f"; first failure: {failures[0]}" if failures else ""))
    if device.type == "cuda" and not failures:
        words, _ = stage_inputs(SERIAL_STAGE, TIMED_TILES * LANES)
        ms = sorted(time_stage(SERIAL_STAGE, to_tensor(words, device)))
        med = ms[len(ms) // 2]
        lanes = TIMED_TILES * LANES
        print(f"stage-9 serial-extract on {torch.cuda.get_device_name(device)}: "
              f"{med:.4f} ms for {lanes} lanes = {med * 1e6 / lanes:.3f} ns/lane")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
