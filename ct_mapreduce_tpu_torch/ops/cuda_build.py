"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into the
checkout's git-ignored ``build/cuda``; the file name carries a hash of
the source, the headers it includes and the flags, so a changed source
or flag never reuses a stale build. Libraries are loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

import torch

from ct_mapreduce_tpu_torch.device import build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found; the CUDA kernels cannot build")


def build(source: str, headers: tuple[str, ...] = (),
          flags: tuple[str, ...] = ()) -> str:
    """Compile ``csrc/<source>`` with NVCC_FLAGS and ``flags`` unless a
    build of this exact source, these headers and these flags exists;
    returns the library's path. Raises with the compiler's output when
    the build fails."""
    src = os.path.join(CSRC, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for path in (src, *(os.path.join(CSRC, x) for x in headers)):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    so = os.path.join(build_dir("cuda"), f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.build.{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


class Library:
    """One kernel library, built and loaded at first use; ``bind`` sets
    the C entry points' argument types, ``flags`` go to ``nvcc`` after
    NVCC_FLAGS."""

    def __init__(self, source: str, headers: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None],
                 flags: tuple[str, ...] = ()) -> None:
        self.source, self.headers, self._bind = source, headers, bind
        self.flags = flags
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> str:
        return os.path.join(CSRC, self.source)

    def build(self) -> str:
        return build(self.source, self.headers, self.flags)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
                self._lib = lib
            return self._lib


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
