"""Moving tensors between the cells of a grid: the port's counterpart of the collectives inside the JAX package's shard_map.

One operation, ``gather``: the tensors that a list of cells computed,
on ``out`` in cell order, on every rank.  On a one-process grid it is a
copy to ``out`` (``Tensor.to(out, non_blocking=True)``).  On a grid of
the joined world (``parallel/mesh.py``) it is one ``dist.all_gather``
over the world: each rank packs its own cells' tensors as bytes into
one buffer, padded to the most cells any rank holds of the list, so
that every rank sends the same number of bytes, and unpacks every
rank's buffer.  Every tensor's shape is fixed by the batch (top-k lists
of rows_l x k, verify tiles, fixed-size triple buffers and their
counts), so no sizes are exchanged and nothing waits for the device:
NCCL enqueues on the current stream.  Every rank makes the same calls
in the same order, because every rank holds the same step outputs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# bytes each packed tensor is padded to, so that every unpacked view is aligned
_ALIGN = 8


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def _on(dev: torch.device):
    """``dev`` as the current CUDA device for the block (the kernels
    launch on the current device's stream); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _cat(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=dim)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def gather(mesh, cells: Sequence[Tuple[int, int]],
           parts: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]],
           spec: Sequence[Tuple[tuple, torch.dtype]],
           out: torch.device) -> List[Tuple[torch.Tensor, ...]]:
    """Each cell's tuple of tensors on ``out``, in the order of ``cells``.

    ``parts`` holds the tuples of the cells this process owns; ``spec``
    gives the (shape, dtype) of each tensor of a tuple, the same for
    every cell, so that a rank owning none of ``cells`` still sends its
    share.  ``out`` is this rank's first device on a grid of the joined
    world."""
    if not mesh.distributed:
        return [tuple(_to(t, out) for t in parts[c]) for c in cells]
    sizes = [-(-_nbytes(s, d) // _ALIGN) * _ALIGN for s, d in spec]
    per = sum(sizes)
    owner = [mesh.ranks[i][j] for i, j in cells]
    slots = max(owner.count(r) for r in range(mesh.world))
    with _on(out):
        send = torch.zeros((slots * per,), dtype=torch.uint8, device=out)
        mine = [c for c, r in zip(cells, owner) if r == mesh.rank]
        for s, c in enumerate(mine):
            off = s * per
            for t, (shape, dtype), size in zip(parts[c], spec, sizes):
                b = _to(t, out).to(dtype).contiguous().reshape(-1).view(torch.uint8)
                send[off : off + b.numel()] = b
                off += size
        recv = [torch.empty_like(send) for _ in range(mesh.world)]
        dist.all_gather(recv, send)
    res, seen = [], [0] * mesh.world
    for r in owner:
        off = seen[r] * per
        seen[r] += 1
        got = []
        for (shape, dtype), size in zip(spec, sizes):
            got.append(recv[r][off : off + _nbytes(shape, dtype)].view(dtype).reshape(shape))
            off += size
        res.append(tuple(got))
    return res
