"""Device-mesh shape from configuration: a copy of the parsing half of
``ct_mapreduce_tpu.parallel.mesh`` (the port imports nothing of the JAX
package).

``meshShape`` config syntax: ``axis:size`` pairs, comma separated —
``"shard:8"``, ``"data:4,expert:2"``. Empty means one 1-D mesh named
``shard`` over every visible device. Sizes must multiply to ≤ the
device count; a trailing ``:-1`` size means "whatever is left" (like a
reshape wildcard). The port runs on one device, so only shapes that
resolve to one device build an aggregator
(``models/ingest_model.py::build_aggregator``); a mesh of more is
ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
