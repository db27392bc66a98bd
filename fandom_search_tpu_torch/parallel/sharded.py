"""Search sharded over a works x script device grid; counterpart of fandom_search_tpu/parallel/sharded.py.

Layout, as in the JAX package:

  * query (fanwork) shingles  -> split over the ``works`` axis;
  * script shingle matrix     -> split over the ``script`` axis;
  * each (works slice x script shard) block runs the same K2 top-k on
    its device, with the shard's own ``ns_valid`` (0 for a shard past
    the script's end);
  * per works slice, the script shards' top-k lists merge exactly into
    one top-k (``merge_topk``): top-k of a union is top-k of the
    per-part top-k's.

The score matrix never exists; only k entries per query and shard move.
``ShardedSearchEngine`` runs the engine's fused step with that
candidate stage (K1 on each works slice plus its (n - 1)-token halo, the
sharded K2, K3 compaction on the stream's device) and with the verify
batch padded to works * 256 pairs and split over the works devices (K4,
or K5 for the lane variants).  Everything else — batching on the host,
dedup, windows, chaining — is the single-device engine's.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from fandom_search_tpu_torch.config import PipelineConfig
from fandom_search_tpu_torch.ops.distance_topk import NEG_INF, topk_dot
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized
from fandom_search_tpu_torch.parallel.mesh import AXIS_SCRIPT, AXIS_WORKS, Mesh, make_mesh
from fandom_search_tpu_torch.search.engine import (
    SearchEngine,
    compact_candidates,
    resolve_device,
)
from fandom_search_tpu_torch.search.index import ScriptIndex

# verify pairs a works shard takes at a time (the JAX sharded verify's tile)
VERIFY_TILE = 256


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def _on(dev: torch.device):
    """``dev`` as the current CUDA device for the block (the kernels
    launch on the current device's stream); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _cat(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=dim)


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The exact top k of each row of f32 ``vals`` [R, m] with global
    int32 indices ``idx`` [R, m] (m >= k), ties to the lowest index:
    (f32 [R, k], int32 [R, k]), best first.  Empty entries (NEG_INF,
    K2's padding) rank below every filled one and come out as
    (NEG_INF, 0), as K2 writes them.

    Ranks one unique int64 key a entry, the f32's order-preserving
    integer image times 2^31 plus (2^31 - 1 - idx): ``torch.topk`` does
    not give ties to the lowest index by itself."""
    bits = vals.contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = ordered * (1 << 31) + ((1 << 31) - 1 - idx.long())
    pos = torch.topk(key, k, dim=1).indices
    v = vals.gather(1, pos)
    return v, torch.where(v == NEG_INF, 0, idx.gather(1, pos))


def _block_topk(row: Sequence[torch.device], q_l: torch.Tensor,
                shards: Sequence[torch.Tensor], ns_valid: Sequence[int], per: int,
                k: int, min_keep: float):
    """One works slice against every script shard of its grid row: K2 on
    each block's device, indices made global, merged on ``row[0]``."""
    if len(row) == 1:
        with _on(row[0]):
            return topk_dot(_to(q_l, row[0]), shards[0], ns_valid[0], k, min_keep=min_keep)
    vals, idx = [], []
    for j, dev in enumerate(row):
        with _on(dev):
            v, ix = topk_dot(_to(q_l, dev), shards[j], ns_valid[j], k, min_keep=min_keep)
            vals.append(_to(v, row[0]))
            idx.append(_to(ix + j * per, row[0]))
    with _on(row[0]):
        return merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), k)


def place_script_shards(mesh: Mesh, s_emb: torch.Tensor) -> List[List[torch.Tensor]]:
    """Int8 ``s_emb`` [NS_pad, dim] cut into one shard of NS_pad / script
    rows per script column, shard j placed on device j of every grid row:
    a [works][script] grid of tensors, one copy a device however often
    the grid names it."""
    script = mesh.shape[AXIS_SCRIPT]
    if s_emb.shape[0] % script:
        raise ValueError(
            f"{s_emb.shape[0]} script rows must split evenly over {script} script shards"
        )
    per = s_emb.shape[0] // script
    placed = {}

    def place(j: int, dev: torch.device) -> torch.Tensor:
        if (dev, j) not in placed:
            placed[(dev, j)] = s_emb[j * per : (j + 1) * per].to(dev)
        return placed[(dev, j)]

    return [[place(j, dev) for j, dev in enumerate(row)] for row in mesh.devices]


def sharded_topk(mesh: Mesh, q_slices: Sequence[torch.Tensor],
                 s_shards: Sequence[Sequence[torch.Tensor]],
                 ns_valid_per_shard: Sequence[int], k: int, *,
                 min_keep: float = -float("inf"), out: torch.device | None = None):
    """Exact global top-k of int8 queries against a script sharded on
    ``mesh``: ``q_slices[i]`` [NQ_i, dim] is works slice i on grid row
    i's first device, ``s_shards`` is ``place_script_shards``'s grid and
    shard j is valid up to ``ns_valid_per_shard[j]``.  Returns (f32
    [NQ, k], int32 [NQ, k]), the slices' rows in works order, on ``out``
    (default: the first slice's device), equal to ``topk_dot`` on the
    whole valid script."""
    per = s_shards[0][0].shape[0]
    out = q_slices[0].device if out is None else out
    vals, idx = [], []
    for row, q_l, shards in zip(mesh.devices, q_slices, s_shards):
        v, ix = _block_topk(row, q_l, shards, ns_valid_per_shard, per, k, min_keep)
        vals.append(_to(v, out))
        idx.append(_to(ix, out))
    return _cat(vals), _cat(idx)


class ShardedSearchEngine(SearchEngine):
    """SearchEngine whose device stages run over a works x script grid.

    Drop-in: the same ``search_works`` and the same rows; only the device
    step is split.  ``mesh`` defaults to ``make_mesh(cfg.mesh)`` over the
    CUDA devices; with ``device="cpu"`` the grid names the CPU
    ``cfg.mesh.num_devices`` times.  The stream's device (``self.device``)
    is the grid's first.
    """

    def __init__(self, index: ScriptIndex, cfg: PipelineConfig, *,
                 mesh: Mesh | None = None, device="cuda"):
        if mesh is None:
            dev = resolve_device(device)
            mesh = make_mesh(cfg.mesh, None if dev.type == "cuda"
                             else [dev] * cfg.mesh.num_devices)
        super().__init__(index, cfg, device=mesh.devices[0][0])
        self.mesh = mesh
        scfg, xcfg = cfg.shingle, cfg.search
        works, script = mesh.shape[AXIS_WORKS], mesh.shape[AXIS_SCRIPT]
        unit = works * VERIFY_TILE
        if xcfg.batch_queries % unit:
            raise ValueError(
                f"batch_queries ({xcfg.batch_queries}) must be divisible by "
                f"works_shards*256 ({unit})"
            )
        # Stream buckets (engine._batches) are granule * pow2, so a
        # granule that is a multiple of works*256 keeps every bucket's
        # query-row count works-shardable.
        self._batch_granule = unit * max(1, self._batch_granule // unit)

        # Re-pad the script matrix so each script shard is aligned.
        ns = index.num_shingles
        per = -(-max(ns, 1) // (script * xcfg.script_pad_multiple))
        per *= xcfg.script_pad_multiple
        s = np.zeros((per * script, scfg.dim), dtype=np.int8)
        s[:ns] = index.embeddings
        self._ns_per_shard = per
        self._ns_valid_shards = [int(np.clip(ns - j * per, 0, per)) for j in range(script)]
        self._s_shards = place_script_shards(mesh, torch.from_numpy(s))
        self._row_mults = [_to(self._dix.mults, row[0]) for row in mesh.devices]
        self._candidates_fn = self._exact_candidates
        self._sw_fn = self._verify_sharded

    def works_slices(self, stream: torch.Tensor) -> List[torch.Tensor]:
        """Works slice i of a batch's token stream on its grid row's
        first device: its rows' tokens plus the (n - 1)-token halo (the
        next slice's head, the stream's tail for the last slice)."""
        n = self.cfg.shingle.n
        rows_l = (stream.shape[0] - n + 1) // self.mesh.shape[AXIS_WORKS]
        return [_to(stream[i * rows_l : (i + 1) * rows_l + n - 1], row[0])
                for i, row in enumerate(self.mesh.devices)]

    def _exact_candidates(self, stream: torch.Tensor, *, max_out: int):
        """K1 per works slice -> sharded K2 -> K3 compaction on the
        stream's device: ``compact_candidates``'s contract."""
        xcfg = self.cfg.search
        q_slices = []
        for row, ext_l, mults in zip(self.mesh.devices, self.works_slices(stream),
                                     self._row_mults):
            with _on(row[0]):
                q_slices.append(embed_shingles(ext_l, mults))
        vals, idx = sharded_topk(self.mesh, q_slices, self._s_shards, self._ns_valid_shards,
                                 xcfg.k, min_keep=xcfg.candidate_threshold, out=self.device)
        return compact_candidates(vals, idx, xcfg.candidate_threshold,
                                  self.index.num_shingles, xcfg.k, max_out)

    def _verify_sharded(self, a, b, len_a, len_b, cfg):
        """``sw_normalized`` with the batch padded to works * 256 pairs
        (zero-length pairs) and split over the works devices."""
        works = self.mesh.shape[AXIS_WORKS]
        bsz = a.shape[0]
        pad = (-bsz) % (works * VERIFY_TILE)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
            len_a = torch.nn.functional.pad(len_a, (0, pad))
            len_b = torch.nn.functional.pad(len_b, (0, pad))
        per = (bsz + pad) // works
        out = []
        for i, row in enumerate(self.mesh.devices):
            sl = slice(i * per, (i + 1) * per)
            dev = row[0]
            with _on(dev):
                out.append(_to(sw_normalized(_to(a[sl], dev), _to(b[sl], dev),
                                             _to(len_a[sl], dev), _to(len_b[sl], dev), cfg),
                               self.device))
        return _cat(out)[:bsz]
