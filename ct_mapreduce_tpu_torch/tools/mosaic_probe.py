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
around back-to-back launches. Exit code 0 iff every stage passed.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ct_mapreduce_tpu_torch.ops import cuda_build

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


LIB = cuda_build.Library("mosaic_probe.cu", ("der_walk.cuh",), _bind)
build = LIB.build


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


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words → an int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        device)


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
    version: ``(words, reads)`` int64[n], the distinct words it touches
    and the byte reads it makes."""
    ln = _Lanes(words, record=True)
    _PLAIN[stage](ln)
    idx = torch.stack(ln.words_read, 1)
    reads = (idx >= 0).sum(1)
    idx = idx.sort(dim=1).values
    new = torch.ones_like(idx, dtype=torch.bool)
    new[:, 1:] = idx[:, 1:] != idx[:, :-1]
    return (new & (idx >= 0)).sum(1), reads


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
    """Milliseconds per launch of a stage kernel: ``reps`` timings, each
    ``calls`` back-to-back launches between one pair of CUDA events."""
    for _ in range(3):
        kernel_stage(stage, words)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            kernel_stage(stage, words)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


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
