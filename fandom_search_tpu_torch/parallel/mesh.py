"""The works x script device grid; counterpart of fandom_search_tpu/parallel/mesh.py.

Two logical axes, as in the JAX package:

  ``works``  — the fanwork (query) dimension, pure data parallelism:
               each works row embeds, searches and verifies its own
               slice of a batch;
  ``script`` — the index dimension: each device of a works row holds a
               slice of the script's shingle matrix, and the per-shard
               top-k lists merge exactly into one.

One process drives the whole grid, as JAX's single controller does: a
``Mesh`` is a [works][script] list of ``torch.device``s, each shard's
kernels launch on its own device, and what JAX does with collectives is
a device-to-device copy (``Tensor.to(dev, non_blocking=True)``) and a
concatenation on the receiving device.  A grid may name one device more
than once: the CPU tests run an 8-shard grid on the CPU, and a machine
with one card runs a 2 x 2 grid as four logical shards of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from fandom_search_tpu_torch.config import MeshConfig

AXIS_WORKS = "works"
AXIS_SCRIPT = "script"


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` runs the block of works slice i and script shard j."""

    devices: List[List[torch.device]]

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_WORKS: len(self.devices), AXIS_SCRIPT: len(self.devices[0])}

    @property
    def num_devices(self) -> int:
        return len(self.devices) * len(self.devices[0])


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


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """The [works][script] grid of ``cfg`` over ``devices`` (default:
    every CUDA device, cuda:0 first), refusing too few devices."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need = cfg.num_devices
    if len(devices) < need:
        raise ValueError(
            f"mesh {cfg.works}x{cfg.script} needs {need} devices, "
            f"have {len(devices)}"
        )
    return Mesh([devices[i * cfg.script : (i + 1) * cfg.script]
                 for i in range(cfg.works)])
