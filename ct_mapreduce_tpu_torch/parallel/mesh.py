"""Device-mesh construction from configuration (port of
``ct_mapreduce_tpu.parallel.mesh``; the port imports nothing of the JAX
package).

``meshShape`` config syntax: ``axis:size`` pairs, comma separated —
``"shard:8"``, ``"data:4,expert:2"``. Empty means one 1-D mesh named
``shard`` over every visible device, matching
:data:`ct_mapreduce_tpu_torch.agg.sharded.AXIS` (the dedup table's
shard axis). Sizes must multiply to ≤ the device count; a trailing
``:-1`` size means "whatever is left" (like a reshape wildcard).

A :class:`Mesh` is a small array of ``torch.device`` shaped like its
axes, with the ``torch.distributed`` rank that drives each device
(0 for every device of a one-process mesh). One process drives every
device of its own rank, as the JAX package's single controller does.
A mesh may name one device more than once: eight shards over one
``cpu`` (what the tests run), or four shards over one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DEFAULT_AXIS = "shard"


@dataclass(frozen=True)
class MeshSpec:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]  # -1 = fill with remaining devices

    @property
    def fixed_size(self) -> int:
        return math.prod(s for s in self.axis_sizes if s > 0)

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        sizes = list(self.axis_sizes)
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one wildcard (-1) axis size")
        fixed = self.fixed_size
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed sizes {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed > n_devices:
            raise ValueError(
                f"mesh needs {fixed} devices, only {n_devices} available"
            )
        return tuple(sizes)


def parse_mesh_shape(spec: str) -> MeshSpec:
    if not spec.strip():
        return MeshSpec((DEFAULT_AXIS,), (-1,))
    names, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"mesh axis {part!r} needs name:size")
        name, _, size = part.partition(":")
        names.append(name.strip())
        sizes.append(int(size))
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate mesh axis names in {spec!r}")
    return MeshSpec(tuple(names), tuple(sizes))


def _object_array(items: Sequence, shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty((len(items),), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr.reshape(shape)


class Mesh:
    """``devices``: ``torch.device`` objects shaped like the axes;
    ``ranks``: the process rank driving each, the same shape."""

    def __init__(self, devices, axis_names: Sequence[str],
                 ranks=None) -> None:
        devs = [torch.device(d) for d in np.asarray(devices,
                                                     dtype=object).flat]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = _object_array(devs, shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")
        self.ranks = (np.zeros(shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def flatten(self, axis: str = DEFAULT_AXIS) -> "Mesh":
        """The same devices on one axis (``build_aggregator`` flattens a
        multi-axis mesh so)."""
        return Mesh(self.devices.reshape(-1), (axis,),
                    self.ranks.reshape(-1))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"{self.axis_names}, ranks={self.ranks.reshape(-1).tolist()})")


def visible_devices(device=None) -> list[torch.device]:
    """The devices an empty or wildcard shape spreads over: every visible
    card, or one ``cpu`` when the caller names the CPU."""
    from ct_mapreduce_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(spec: "str | MeshSpec" = "", devices=None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The :class:`Mesh` for a config's ``meshShape``: over ``devices``
    (their first ``prod(sizes)``; a device may repeat) or, by default,
    over every visible card. ``ranks`` names each device's process
    (``parallel.distributed.global_mesh_devices`` gives both for a mesh
    across processes)."""
    if isinstance(spec, str):
        spec = parse_mesh_shape(spec)
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    sizes = spec.resolve(len(devices))
    n = math.prod(sizes)
    grid = _object_array(devices[:n], sizes)
    rk = None if ranks is None else np.asarray(ranks[:n]).reshape(sizes)
    return Mesh(grid, spec.axis_names, rk)
