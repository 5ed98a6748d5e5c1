"""Wrapper of the hand-written Hopper ECDSA verify K6
(``csrc/ecdsa_verify.cu``), which replaces the JAX package's jitted
verify kernels ``ct_mapreduce_tpu/ops/ecdsa.py::_verify_windowed`` and
``::_verify_jacobian``.

Built by :mod:`.cuda_build` at first use and loaded with ``ctypes``. The
plain PyTorch versions beside it are
:func:`ct_mapreduce_tpu_torch.ops.ecdsa._verify_windowed` and
:func:`~ct_mapreduce_tpu_torch.ops.ecdsa._verify_jacobian`. Each curve's
constants (moduli, Montgomery constants, b, G and the Fermat exponents
as 32-bit limbs) are copied into the kernel's constant memory once per
device, before the first launch. The kernel verifies a signature with a
group of threads, :func:`block_lanes` signatures a block, whose s and Z
it inverts by one batch inversion each; it allocates nothing.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ct_mapreduce_tpu_torch.ops import cuda_build
from ct_mapreduce_tpu_torch.ops.cuda_build import check_tensor

#: Kernel launches made through :func:`verify_windowed` and
#: :func:`verify_jacobian` (an empty batch launches nothing and does not
#: count).
LAUNCHES = 0

CURVE_INDEX = {"p256": 0, "p384": 1}  # the kernel's constant slot
# Signatures a block (``kSigsW`` / ``kSigsJ`` in the kernel) of the
# windowed and the window-0 ladder: the width of their batch
# inversions. :func:`lanes_per_block` reads the built kernel's.
WINDOWED_LANES_PER_BLOCK = 64
JACOBIAN_LANES_PER_BLOCK = 128
MAX_WORDS = 12  # 32-bit limbs of the widest curve (P-384)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ctmr_ecdsa_lanes_per_block.restype = i
    lib.ctmr_ecdsa_lanes_per_block.argtypes = [i]
    lib.ctmr_ecdsa_set_constants.restype = i
    lib.ctmr_ecdsa_set_constants.argtypes = [i, p, p, i]
    lib.ctmr_ecdsa_verify_windowed.restype = i
    lib.ctmr_ecdsa_verify_windowed.argtypes = [
        i, p, p, p, p, p, p, p, p, p, i, i, p, ll, i, p]
    lib.ctmr_ecdsa_verify_jacobian.restype = i
    lib.ctmr_ecdsa_verify_jacobian.argtypes = [
        i, p, p, p, p, p, p, p, ll, i, p]


# The kernels' products are unrolled, so most of the build is the
# optimizer's; split compilation runs it on the host's cores at once
# (about 50 s down to 25-35 s on an 8-core H100 host).
LIB = cuda_build.Library("ecdsa_verify.cu", (), _bind,
                         ("-split-compile=0",))
build = LIB.build


def block_lanes(window: int) -> int:
    """Signatures a block of the ladder of ``window`` (0: Jacobian)."""
    return WINDOWED_LANES_PER_BLOCK if window else JACOBIAN_LANES_PER_BLOCK


def lanes_per_block(window: int) -> int:
    """The built kernel's :func:`block_lanes` (builds it)."""
    return int(LIB.get().ctmr_ecdsa_lanes_per_block(window))


_SET_LOCK = threading.Lock()
_CONSTANTS_ON: set = set()  # (device index, curve) with constants set


def products(ops, window: int, ok: bool, u1: int = 0, u2: int = 0,
             infinity: bool = False) -> int:
    """Montgomery products one lane needs, for a lane that passed the
    range checks: ``ok`` is its on-curve check, (u1, u2) its scalars and
    ``infinity`` whether its result is at infinity. A lane failing a
    range check (or a padding lane) needs none (:func:`muls_per_product`
    turns products into multiply instructions).

    s⁻¹ and the result's 1/Z are batch inversions at every window: 3
    products a lane each here (``bigint.batch_inv_mont``'s prefix
    product, unwind and the lane's own inverse), the rest of the batch's
    work apart (:func:`batch_products_needed` for the function K6
    replaces, :func:`block_products` for K6). At window 0, where
    ``_verify_jacobian`` inverts lane by lane, the count takes K6's batch
    form, so that the bound counts no work K6 does not need; T = G + Q
    keeps a Fermat inversion a lane in both. K6's loops execute the
    same products a lane."""
    if not ok:
        return 5  # the key to Montgomery form, and the on-curve check
    nbits = ops.nbits
    total = 5 + 1 + 3 + 6  # checks, s to Montgomery, s's share, u1 and u2
    if window:
        total += 13 * (_nonzero_digits(u1, window, nbits)
                       + _nonzero_digits(u2, window, nbits))
        return total + (0 if infinity else 3 + 2)  # Z's share, x = X / Z
    # Window 0: T = G + Q and its affine form, then a double (8) and an
    # addition a bit; the addition costs 8 products while the sum is at
    # infinity (down to the top set bit) or the addend is, else 11.
    lead = max(u1.bit_length(), u2.bit_length())
    general = bin((u1 | u2) & ((1 << max(lead - 1, 0)) - 1)).count("1")
    total += 11 + chain_products(ops)[1] + 4 + 16 * nbits + 3 * general
    return total + (0 if infinity else 3 + 3)  # Z's share, x = X / Z^2


def chain_products(ops) -> tuple[int, int]:
    """Products of one Fermat inversion mod n and mod p (``a^(m-2)``:
    a square an exponent bit, a product a set bit)."""
    c = ops.curve
    return (ops.nbits + bin(c.n - 2).count("1"),
            ops.nbits + bin(c.p - 2).count("1"))


def batch_products_needed(ops) -> int:
    """Products a batch needs once, spread over its lanes: the Fermat
    chains of its two batch inversions (mod n for s, mod p for Z)."""
    return sum(chain_products(ops))


def _live_per_block(window: int, live) -> np.ndarray:
    """Live lanes in each block of :func:`block_lanes` lanes."""
    b = block_lanes(window)
    live = np.asarray(live, bool)
    return np.pad(live, (0, (-live.size) % b)).reshape(-1, b).sum(axis=1)


def block_products(ops, window: int, live_s, live_z) -> int:
    """K6's batch-inversion products beyond the lanes' shares of
    :func:`products`: a block of b = :func:`block_lanes` lanes with a
    lane whose s it inverts (``live_s``: the lanes that pass every input
    check) runs a product tree over all its lanes, b - 1 products up and
    2 (b - 1) down, and two to bring the root's inverse (a binary GCD,
    no product) back to the Montgomery domain: 3 b - 1, less the 3 a
    live lane that :func:`products` counts; the same mod p over the
    lanes whose result is not at infinity (``live_z``). May be
    negative."""
    b = block_lanes(window)
    return sum(int(((3 * b - 1) - 3 * per)[per > 0].sum())
               for per in (_live_per_block(window, live_s),
                           _live_per_block(window, live_z)))


def block_gcds(window: int, live_s, live_z) -> int:
    """Binary-GCD inversions K6 runs: one a block and a batch inversion
    with a live lane."""
    return sum(int((_live_per_block(window, live) > 0).sum())
               for live in (live_s, live_z))


def _nonzero_digits(u: int, window: int, nbits: int) -> int:
    """The nonzero ``window``-bit digits of ``u`` (a zero digit keeps
    the sum and costs nothing)."""
    if window == 8:
        b = u.to_bytes(nbits // 8, "little")
        return len(b) - b.count(0)
    mask = (1 << window) - 1
    return sum((u >> (window * j)) & mask != 0
               for j in range(nbits // window))


def muls_per_product(ops) -> int:
    """32-bit multiply instructions of one Montgomery product: nl² limb
    products for a·b and nl² for the reduction, each a mul.lo and a
    mul.hi."""
    nl = ops.byte_len // 4
    return 4 * nl * nl


def _words(v: int) -> list[int]:
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(MAX_WORDS)]


def curve_constants(ops) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's constant words of ``ops``' curve: uint32[11, 12] in
    the order of ``enum Field`` (p, n, R² mod p, R² mod n, R mod p, R
    mod n, b·R mod p, G·R mod p, p - 2, n - 2), and uint32[2] (-p⁻¹,
    -n⁻¹ mod 2^32). R = 2^(32·nl) = the JAX package's 2^(16·2nl)."""
    c = ops.curve
    r = 1 << ops.nbits
    p, n = c.p, c.n
    rows = [p, n, r * r % p, r * r % n, r % p, r % n, c.b * r % p,
            c.gx * r % p, c.gy * r % p, p - 2, n - 2]
    words = np.array([_words(v) for v in rows], np.uint32)
    minv = np.array([(-pow(p, -1, 1 << 32)) % (1 << 32),
                     (-pow(n, -1, 1 << 32)) % (1 << 32)], np.uint32)
    return words, minv


def _ensure_constants(lib, ops, dev: torch.device) -> None:
    key = (dev.index or 0, ops.name)
    if key in _CONSTANTS_ON:
        return
    with _SET_LOCK:
        if key in _CONSTANTS_ON:
            return
        words, minv = curve_constants(ops)
        # The copy runs on the legacy default stream; finish the
        # current stream's work first so nothing reads half a set.
        torch.cuda.synchronize(dev)
        rc = lib.ctmr_ecdsa_set_constants(
            CURVE_INDEX[ops.name], words.ctypes.data, minv.ctypes.data,
            dev.index or 0)
        cuda_build.raise_on(rc, "ECDSA verify constants")
        _CONSTANTS_ON.add(key)


def _check_rows(ops, dev, digest, r, s, qx, qy, valid) -> int:
    if dev.type != "cuda":
        raise ValueError(f"the ECDSA verify kernel needs CUDA tensors, got {dev}")
    b = int(digest.shape[0]) if digest.dim() == 2 else -1
    for name, t in (("digest", digest), ("r", r), ("s", s), ("qx", qx),
                    ("qy", qy)):
        check_tensor(name, t, torch.uint8, (b, ops.byte_len), dev)
    check_tensor("valid", valid, torch.bool, (b,), dev)
    return b


def verify_windowed(ops, digest: torch.Tensor, r: torch.Tensor,
                    s: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                    valid: torch.Tensor, key_idx: torch.Tensor,
                    gtab: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """Launch the windowed ladder on the current stream: bool[B] verdicts.

    Rows uint8[B, byte_len] big-endian (a P-384 digest left-padded),
    ``valid`` bool[B], ``key_idx`` int32[B] (clamped into the slots),
    ``gtab`` packed int32[nwin, 2^w, 2, nl32] and ``qtab`` packed
    int32[K, nwin, 2^w, 2, nl32] (:func:`..ecdsa.pack_table`); all
    contiguous on one CUDA device."""
    global LAUNCHES
    dev = digest.device
    b = _check_rows(ops, dev, digest, r, s, qx, qy, valid)
    check_tensor("key_idx", key_idx, torch.int32, (b,), dev)
    nl32 = ops.byte_len // 4
    entries = int(gtab.shape[1]) if gtab.dim() == 4 else -1
    w = entries.bit_length() - 1
    if w not in (2, 4, 8) or entries != 1 << w:
        raise ValueError(f"gtab has {entries} entries a window; want 4, 16 "
                         "or 256")
    nwin = 32 * nl32 // w
    check_tensor("gtab", gtab, torch.int32, (nwin, entries, 2, nl32), dev)
    k = int(qtab.shape[0]) if qtab.dim() == 5 else -1
    check_tensor("qtab", qtab, torch.int32, (k, nwin, entries, 2, nl32), dev)
    if k < 1:
        raise ValueError("qtab has no slots")
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = LIB.get()
    _ensure_constants(lib, ops, dev)
    rc = lib.ctmr_ecdsa_verify_windowed(
        nl32, digest.data_ptr(), r.data_ptr(), s.data_ptr(), qx.data_ptr(),
        qy.data_ptr(), valid.data_ptr(), key_idx.data_ptr(),
        gtab.data_ptr(), qtab.data_ptr(), w, k, out.data_ptr(), b,
        dev.index or 0, cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "ECDSA windowed verify kernel")
    LAUNCHES += 1
    return out


def verify_jacobian(ops, digest: torch.Tensor, r: torch.Tensor,
                    s: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Launch the window-0 (Jacobian) ladder on the current stream:
    bool[B] verdicts; arguments as :func:`verify_windowed`."""
    global LAUNCHES
    dev = digest.device
    b = _check_rows(ops, dev, digest, r, s, qx, qy, valid)
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = LIB.get()
    _ensure_constants(lib, ops, dev)
    rc = lib.ctmr_ecdsa_verify_jacobian(
        ops.byte_len // 4, digest.data_ptr(), r.data_ptr(), s.data_ptr(),
        qx.data_ptr(), qy.data_ptr(), valid.data_ptr(), out.data_ptr(), b,
        dev.index or 0, cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "ECDSA Jacobian verify kernel")
    LAUNCHES += 1
    return out
