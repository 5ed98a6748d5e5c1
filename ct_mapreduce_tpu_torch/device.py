"""Device selection and the build directory for compiled libraries."""

from __future__ import annotations

import os

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent CPU fallback: without a CUDA device,
    only an explicit ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def build_dir(*parts: str) -> str:
    """``<checkout>/build/<parts>``, created on demand. Compiled
    libraries go here (the directory is git-ignored), never beside
    their sources."""
    path = os.path.join(_REPO_ROOT, "build", *parts)
    os.makedirs(path, exist_ok=True)
    return path
