"""Multi-process initialization and coordination over ``torch.distributed``
(port of ``ct_mapreduce_tpu.parallel.distributed``, which wraps
``jax.distributed``).

- :func:`initialize_multihost` joins the process group: rank 0 hosts the
  TCP store, every other rank connects to it. With no arguments it joins
  only when ``MASTER_ADDR`` and ``WORLD_SIZE`` are set (the
  ``env://`` rendezvous); otherwise it stays local, as the JAX package
  stays local without a coordinator in its environment.
- Leadership is ``rank == 0``: fixed, no contention.
- :func:`device_barrier` is a collective (an ``all_reduce`` of ones), so
  every rank leaves it together.
- :func:`kv_put` / :func:`kv_get` ride the default group's store, the
  fleet coordinator's epoch and shutdown fabric.

The backend is NCCL when every rank can have a card of its own, and
gloo on the CPU or when ranks share a card (a sharded step then stages
its exchange buffers through host memory; ``agg/sharded.py`` says so).

:class:`DistributedCoordinator` exposes the reference Coordinator's
interface (``await_leader`` / ``await_start`` / ``send_start``) on top
of these, so callers swap fabrics by construction alone.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch
import torch.distributed as dist

from ct_mapreduce_tpu_torch.device import resolve_device

# The env:// rendezvous needs both; with them set, an argument-less
# initialize_multihost joins the group.
_ENV_REQUIRED = ("MASTER_ADDR", "WORLD_SIZE")


def _default_backend(world_size: int) -> str:
    """NCCL when each rank can take a card of its own, else gloo."""
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (no-op when already joined).
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    rank 0's store; ``backend`` overrides the NCCL-or-gloo choice."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if not all(os.environ.get(k) for k in _ENV_REQUIRED):
            return  # one process: nothing to join
        world = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(backend or _default_backend(world),
                                init_method="env://")
        _pin_card()
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_multihost needs the address, the "
                         "number of processes and this process's id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend or _default_backend(num_processes),
                            init_method=url, world_size=num_processes,
                            rank=process_id)
    _pin_card()


def _pin_card() -> None:
    """Under NCCL rank r drives card r (its collectives run there)."""
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """This rank's device: the named one, else its own card under NCCL,
    else the current card (ranks sharing one card under gloo). As
    everywhere in the port there is no silent CPU fallback: without a
    card only a named ``cpu`` runs (``device.resolve_device``)."""
    if device is None and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def global_mesh_devices(local_devices) -> tuple[list, list[int]]:
    """Every rank's devices in rank order, and the rank of each: the
    ``devices`` and ``ranks`` of a :func:`..parallel.mesh.make_mesh`
    whose shards span the processes. Every rank must pass as many."""
    local = [str(torch.device(d)) for d in local_devices]
    if not dist.is_initialized():
        return [torch.device(d) for d in local], [0] * len(local)
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    if len({len(g) for g in gathered}) != 1:
        raise ValueError("every rank must bring as many devices to the mesh")
    devices, ranks = [], []
    for r, devs in enumerate(gathered):
        devices += [torch.device(d) for d in devs]
        ranks += [r] * len(devs)
    return devices, ranks


def _store():
    if not dist.is_initialized():
        return None
    return dist.distributed_c10d._get_default_store()


def kv_put(key: str, value: str) -> bool:
    """Publish ``value`` under ``key`` on the group's store; False when
    there is no group (one process: the caller keeps local state)."""
    store = _store()
    if store is None:
        return False
    store.set(key, value)
    return True


def kv_get(key: str) -> Optional[str]:
    """Non-blocking read of a store entry; None when absent or when there
    is no group."""
    store = _store()
    if store is None or not store.check([key]):
        return None
    return store.get(key).decode()


def is_leader() -> bool:
    """Rank-0 leadership: the fixed, contention-free analog of winning
    the SETNX election."""
    return rank() == 0


def device_barrier(tag: str = "barrier") -> None:
    """Block until every rank reaches the barrier: an ``all_reduce`` of
    ones on the backend's device. ``tag`` names it in errors."""
    if not dist.is_initialized():
        return
    dev = (local_device() if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    x = torch.ones((1,), dtype=torch.int32, device=dev)
    dist.all_reduce(x)
    total = int(x.item())
    if total != dist.get_world_size():
        raise RuntimeError(f"{tag}: barrier sum {total} != "
                           f"{dist.get_world_size()}")


class DistributedCoordinator:
    """Reference-Coordinator interface over the process group.

    await_leader: returns rank-0 status (no contention to win).
    send_start / await_start: both sides enter the barrier; the
    leader's entry releases the followers, as publishing
    ``started-<id>`` does in the Redis protocol."""

    def __init__(self, name: str = "ct-fetch"):
        self.name = name
        self.is_leader = False
        self.identifier = ""

    def await_leader(self) -> bool:
        self.is_leader = is_leader()
        self.identifier = f"torch-rank-{rank()}"
        return self.is_leader

    def await_start(self, timeout_s: Optional[float] = None) -> None:
        if not self.identifier:
            raise RuntimeError("Must not call before await_leader completes")
        if self.is_leader:
            raise RuntimeError("Must not call unless we're a follower")
        if timeout_s is None:
            device_barrier(f"start-{self.name}")
            return
        # A collective has no timeout of its own: wait on a thread. On
        # expiry the thread and its collective are abandoned; the caller
        # treats the TimeoutError as fatal, like the reference's polled
        # barrier timeout.
        err: list[BaseException] = []

        def run():
            try:
                device_barrier(f"start-{self.name}")
            except BaseException as e:  # surfaced to the caller below
                err.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            raise TimeoutError("start barrier")
        if err:
            raise err[0]

    def send_start(self) -> None:
        if not self.identifier:
            raise RuntimeError("Must not call before await_leader completes")
        if not self.is_leader:
            raise RuntimeError("Must not call unless we're leader")
        device_barrier(f"start-{self.name}")

    def close(self) -> None:
        pass
