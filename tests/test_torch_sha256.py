"""The port's SHA-256 and fingerprints against the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions
(the Pallas kernel in interpret mode, as tests/test_pallas.py runs it on
the CPU), the port's plain PyTorch version and ``hashlib``. Tolerance:
exact equality — all of this is integer arithmetic.
"""

import hashlib

import numpy as np
import pytest
import torch

from ct_mapreduce_tpu.core import packing as jpacking
from ct_mapreduce_tpu.ops import pallas_sha256
from ct_mapreduce_tpu.ops import pipeline as jpipeline
from ct_mapreduce_tpu.ops import sha256 as jsha256
from ct_mapreduce_tpu_torch import device as tdevice
from ct_mapreduce_tpu_torch.core import packing
from ct_mapreduce_tpu_torch.ops import pipeline, sha256, sha256_cuda


@pytest.fixture(scope="module")
def blocks():
    """One random message of every length 0..55 plus 72 more, padded
    into single blocks."""
    rng = np.random.default_rng(11)
    lens = list(range(56)) + list(rng.integers(0, 56, 72))
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    blk = np.stack([sha256.pad_message_np(m, total_blocks=1)[0] for m in msgs])
    return blk, msgs


@pytest.fixture(scope="module")
def fields():
    """Fingerprint inputs covering every serial length 0..46 (three
    lanes each), issuer indices past 2^13 and exp hours with the top
    bit set."""
    rng = np.random.default_rng(12)
    slen = np.repeat(np.arange(packing.MAX_SERIAL_BYTES + 1), 3).astype(np.int32)
    n = slen.size
    ser = rng.integers(0, 256, (n, packing.MAX_SERIAL_BYTES), dtype=np.uint8)
    ser[np.arange(packing.MAX_SERIAL_BYTES)[None, :] >= slen[:, None]] = 0
    ii = rng.integers(0, 1 << 14, n).astype(np.int32)
    eh = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    eh[: n // 2] = rng.integers(400_000, 700_000, n // 2)
    return ii, eh, ser, slen


def test_single_block_matches_jax_pallas_and_hashlib(blocks):
    blk, msgs = blocks
    got = sha256.sha256_single_block(torch.from_numpy(blk.view(np.int32)))
    got = got.numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jsha256.sha256_single_block(blk)))
    np.testing.assert_array_equal(got, np.asarray(
        pallas_sha256.sha256_single_block_pallas(blk, interpret=True)))
    for i, msg in enumerate(msgs):
        assert sha256.digest_np(got[i]) == hashlib.sha256(msg).digest()


def test_fingerprints_match_jax_and_host(fields):
    ii, eh, ser, slen = fields
    got = pipeline.fingerprints(*(torch.from_numpy(a) for a in fields))
    assert got.dtype == torch.int32 and got.shape == (ii.size, 4)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jpipeline.fingerprints(*fields)))
    np.testing.assert_array_equal(got, jpacking.fingerprints_np(*fields))
    np.testing.assert_array_equal(got, packing.fingerprints_np(*fields))
    for i in range(ii.size):
        serial = ser[i, : slen[i]].tobytes()
        assert tuple(got[i]) == packing.fingerprint_host(
            int(ii[i]), int(eh[i]), serial)
        digest = hashlib.sha256(packing.fingerprint_message(
            int(ii[i]), int(eh[i]), serial)).digest()
        assert got[i].astype(">u4").tobytes() == digest[16:]


def test_message_blocks_match_jax_block_build(fields):
    """The plain block build is the JAX pipeline's message layout: its
    digest tail equals the JAX fingerprint of the same fields, and the
    Pallas kernel agrees on the same blocks."""
    blk = sha256.message_blocks(*(torch.from_numpy(a) for a in fields))
    blk = blk.numpy().astype(np.uint32)
    tail = np.asarray(pallas_sha256.sha256_fingerprint64_pallas(
        blk, interpret=True))
    np.testing.assert_array_equal(tail, np.asarray(jpipeline.fingerprints(*fields)))


def test_kernel_wrapper_rejects_cpu_tensors(fields):
    args = [torch.from_numpy(a) for a in fields]
    with pytest.raises(ValueError, match="CUDA"):
        sha256_cuda.fingerprint64(*args)
    before = sha256_cuda.LAUNCHES
    sha256.sha256_fingerprint64(*args)  # CPU tensors: the plain version
    assert sha256_cuda.LAUNCHES == before
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no fingerprint path"):
        sha256.sha256_fingerprint64(*meta)


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
