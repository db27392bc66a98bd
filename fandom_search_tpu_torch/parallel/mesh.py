"""The works x script device grid; counterpart of fandom_search_tpu/parallel/mesh.py.

Two logical axes, as in the JAX package:

  ``works``  — the fanwork (query) dimension, pure data parallelism:
               each works row embeds, searches and verifies its own
               slice of a batch;
  ``script`` — the index dimension: each device of a works row holds a
               slice of the script's shingle matrix, and the per-shard
               top-k lists merge exactly into one.

A ``Mesh`` is a [works][script] grid of cells, each a ``torch.device``
and the rank of the process that owns it.  Without
``initialize_multihost`` one process owns every cell, as JAX's single
controller does, and what JAX does with collectives is a copy to the
receiving device (``parallel/comm.py``).  After it, ``make_mesh`` lays
the grid over the global device list: every rank's devices in rank
order, rank 0's first, as ``jax.devices()`` orders processes.  Every
rank runs the same command on the same inputs and builds the same host
stream; each computes only the cells it owns, and after each split stage
an ``all_gather`` (NCCL on the card, gloo on the CPU) gives every rank
the same results, so every rank ends with the same rows.  A grid may
name one device more than once within a rank: the CPU tests run an
8-shard grid on the CPU, and a machine with one card runs a 2 x 2 grid
as four logical shards of it.
"""

from __future__ import annotations

import datetime
import json
import socket
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from fandom_search_tpu_torch.config import MeshConfig

AXIS_WORKS = "works"
AXIS_SCRIPT = "script"


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` runs the block of works slice i and script shard
    j; ``ranks[i][j]`` is the rank that owns it (None: every cell is this
    process's, and cells exchange tensors by copies)."""

    devices: List[List[torch.device]]
    ranks: Optional[List[List[int]]] = None
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_WORKS: len(self.devices), AXIS_SCRIPT: len(self.devices[0])}

    @property
    def num_devices(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    def local(self, i: int, j: int) -> bool:
        """Whether this process owns cell (i, j)."""
        return self.ranks is None or self.ranks[i][j] == self.rank

    def head(self, i: int) -> Optional[torch.device]:
        """The device of the first cell of works row i that this process
        owns (None: it owns none of the row)."""
        for j, dev in enumerate(self.devices[i]):
            if self.local(i, j):
                return dev
        return None


@dataclass(frozen=True)
class _World:
    rank: int
    size: int
    devices: List[torch.device]   # the global device list, rank order
    ranks: List[int]              # the rank owning each of them


_WORLD: Optional[_World] = None
# store keys of each rank's device list
_DEVICES_KEY = "fandom_search_tpu_torch/devices"


def _identity(dev: torch.device) -> Optional[str]:
    """Host and UUID of a card (None on the CPU): two ranks naming the
    same card is what NCCL refuses."""
    if dev.type != "cuda":
        return None
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device,
    local_devices: int | None = None,
    timeout_s: float = 600.0,
) -> int:
    """Join a multi-process world over ``torch.distributed``; returns the
    global device count.  Idempotent, like the JAX package's function.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU, and
    never one in place of the other: without CUDA a CUDA world raises.
    The rendezvous is ``tcp://coordinator_address`` with the given world
    size and rank; with no coordinator it is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where explicit arguments
    override the variables.  A rank's devices are the cards
    ``CUDA_VISIBLE_DEVICES`` shows it (the first becomes its current
    device), or on the CPU the CPU named ``local_devices`` times
    (default once).  Two ranks naming one card are refused: NCCL rejects
    a duplicate GPU in one communicator.  Collectives fail after
    ``timeout_s`` instead of hanging."""
    global _WORLD
    if _WORLD is not None:
        return len(_WORLD.devices)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--multihost on cuda needs CUDA and NCCL, and CUDA is not "
                "available; pass --device cpu for a gloo world"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("--multihost on cuda needs NCCL, which this torch lacks")
        backend = "nccl"
        n = torch.cuda.device_count() if local_devices is None else local_devices
        local = [torch.device("cuda", i) for i in range(n)]
        torch.cuda.set_device(local[0])
    elif dev.type == "cpu":
        backend = "gloo"
        local = [dev] * (local_devices or 1)
    else:
        raise ValueError(f"unsupported device {dev}")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(
        backend,
        init_method="env://" if coordinator_address is None else f"tcp://{coordinator_address}",
        timeout=datetime.timedelta(seconds=timeout_s),
        **kw,
    )
    rank, size = dist.get_rank(), dist.get_world_size()
    # device lists go through the rendezvous store, not a collective:
    # NCCL would fail on a duplicate card before the check below
    store = dist.distributed_c10d._get_default_store()
    store.set(f"{_DEVICES_KEY}/{rank}",
              json.dumps([[str(d), _identity(d)] for d in local]))
    devices, ranks, owner = [], [], {}
    for r in range(size):
        for name, ident in json.loads(store.get(f"{_DEVICES_KEY}/{r}")):
            if ident is not None and owner.setdefault(ident, r) != r:
                dist.destroy_process_group()
                raise ValueError(
                    f"ranks {owner[ident]} and {r} both name card {ident}: NCCL "
                    "rejects a duplicate GPU in one communicator; give each rank "
                    "its own cards (CUDA_VISIBLE_DEVICES)"
                )
            devices.append(torch.device(name))
            ranks.append(r)
    _WORLD = _World(rank, size, devices, ranks)
    return len(devices)


def multihost_world() -> Optional[_World]:
    """The joined world (None before ``initialize_multihost``)."""
    return _WORLD


def shutdown_multihost() -> None:
    """Leave the world joined by ``initialize_multihost`` (no-op without one)."""
    global _WORLD
    if _WORLD is not None:
        _WORLD = None
        dist.destroy_process_group()


def mesh_shape_for(n_devices: int, prefer_script: int = 1) -> tuple[int, int]:
    """(works, script) factorization of a device count.

    The works axis carries the heavy data parallelism, so it takes
    every device not claimed by ``prefer_script`` (clamped to the
    largest divisor of ``n_devices`` that is <= prefer_script).
    """
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    script = max(d for d in range(1, prefer_script + 1) if n_devices % d == 0)
    return n_devices // script, script


def make_mesh(cfg: MeshConfig, devices=None, *, ranks=None) -> Mesh:
    """The [works][script] grid of ``cfg`` over ``devices``, refusing too
    few devices.  The default is the global device list after
    ``initialize_multihost``, else every CUDA device, cuda:0 first.
    ``ranks`` (one a device) makes a grid of the joined world from an
    explicit list, each device named as its owner names it; every rank
    must own a cell."""
    if devices is None:
        if _WORLD is not None:
            devices, ranks = _WORLD.devices, _WORLD.ranks
        else:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need = cfg.num_devices
    if len(devices) < need:
        raise ValueError(
            f"mesh {cfg.works}x{cfg.script} needs {need} devices, "
            f"have {len(devices)}"
        )

    def grid(xs):
        return [list(xs[i * cfg.script : (i + 1) * cfg.script]) for i in range(cfg.works)]

    if ranks is None:
        return Mesh(grid(devices))
    if _WORLD is None:
        raise RuntimeError("a grid with ranks needs initialize_multihost first")
    idle = sorted(set(range(_WORLD.size)) - set(ranks[:need]))
    if idle:
        raise ValueError(
            f"mesh {cfg.works}x{cfg.script} leaves rank(s) {idle} without a cell; "
            "every rank must own one"
        )
    return Mesh(grid(devices), grid(ranks), rank=_WORLD.rank, world=_WORLD.size)
