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

On a grid of several processes (``parallel/mesh.py``) every rank holds
the whole host stream and the whole script index on its first device,
computes the blocks and verify tiles of its own cells, and receives the
others' through ``comm.gather``; compaction (K3) and the fused tail run
on every rank, on the same inputs, so every rank holds the same step
output and takes the same budget retries.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from fandom_search_tpu_torch.config import PipelineConfig
from fandom_search_tpu_torch.ops.distance_topk import NEG_INF, topk_dot
from fandom_search_tpu_torch.ops.embed import embed_shingles
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized
from fandom_search_tpu_torch.parallel.comm import _cat, _on, _to, gather
from fandom_search_tpu_torch.parallel.mesh import (
    AXIS_SCRIPT,
    AXIS_WORKS,
    Mesh,
    make_mesh,
    multihost_world,
)
from fandom_search_tpu_torch.search.engine import (
    SearchEngine,
    compact_candidates,
    resolve_device,
)
from fandom_search_tpu_torch.search.index import ScriptIndex

# verify pairs a works shard takes at a time (the JAX sharded verify's tile)
VERIFY_TILE = 256


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


def place_script_shards(mesh: Mesh, s_emb: torch.Tensor) -> List[List[torch.Tensor]]:
    """Int8 ``s_emb`` [NS_pad, dim] cut into one shard of NS_pad / script
    rows per script column, shard j placed on device j of every grid row:
    a [works][script] grid of tensors, one copy a device however often
    the grid names it, None at the cells of other ranks."""
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

    return [[place(j, dev) if mesh.local(i, j) else None for j, dev in enumerate(row)]
            for i, row in enumerate(mesh.devices)]


def sharded_topk(mesh: Mesh, q_slices: Sequence[torch.Tensor | None],
                 s_shards: Sequence[Sequence[torch.Tensor | None]],
                 ns_valid_per_shard: Sequence[int], k: int, *,
                 min_keep: float = -float("inf"), out: torch.device | None = None):
    """Exact global top-k of int8 queries against a script sharded on
    ``mesh``: ``q_slices[i]`` [NQ_i, dim] is works slice i on a device of
    grid row i that this process owns (None where it owns none),
    ``s_shards`` is ``place_script_shards``'s grid and shard j is valid
    up to ``ns_valid_per_shard[j]``.  Each owned cell runs K2 on its
    block, the blocks' lists reach ``out`` (default: the first slice's
    device) through ``comm.gather`` and merge there row by row
    (``merge_topk``).  Returns (f32 [NQ, k], int32 [NQ, k]), the slices'
    rows in works order, equal to ``topk_dot`` on the whole valid
    script."""
    works, script = mesh.shape[AXIS_WORKS], mesh.shape[AXIS_SCRIPT]
    mine = [q for q in q_slices if q is not None]
    rows_l = mine[0].shape[0]
    per = next(sh for row in s_shards for sh in row if sh is not None).shape[0]
    out = mine[0].device if out is None else out
    parts = {}
    for i, (row, q_l) in enumerate(zip(mesh.devices, q_slices)):
        for j, dev in enumerate(row):
            if mesh.local(i, j):
                with _on(dev):
                    v, ix = topk_dot(_to(q_l, dev), s_shards[i][j], ns_valid_per_shard[j], k,
                                     min_keep=min_keep)
                    parts[(i, j)] = (v, ix + j * per if j else ix)
    cells = [(i, j) for i in range(works) for j in range(script)]
    spec = (((rows_l, k), torch.float32), ((rows_l, k), torch.int32))
    blocks = gather(mesh, cells, parts, spec, out)
    vals, idx = [], []
    with _on(out):
        for i in range(works):
            row = blocks[i * script : (i + 1) * script]
            if script == 1:
                v, ix = row[0]
            else:
                v, ix = merge_topk(torch.cat([b[0] for b in row], 1),
                                   torch.cat([b[1] for b in row], 1), k)
            vals.append(v)
            idx.append(ix)
    return _cat(vals), _cat(idx)


class ShardedSearchEngine(SearchEngine):
    """SearchEngine whose device stages run over a works x script grid.

    Drop-in: the same ``search_works`` and the same rows; only the device
    step is split.  ``mesh`` defaults to ``make_mesh(cfg.mesh)``: after
    ``initialize_multihost`` over the world's global device list, else
    over the CUDA devices, or with ``device="cpu"`` over the CPU named
    ``cfg.mesh.num_devices`` times.  The stream's device
    (``self.device``) is the first cell this process owns.
    """

    def __init__(self, index: ScriptIndex, cfg: PipelineConfig, *,
                 mesh: Mesh | None = None, device="cuda"):
        if mesh is None:
            dev = resolve_device(device)
            world = multihost_world()
            if world is not None:
                if world.devices[0].type != dev.type:
                    raise ValueError(
                        f"the multihost world runs on {world.devices[0].type}, "
                        f"not on {dev.type}"
                    )
                mesh = make_mesh(cfg.mesh)
            else:
                mesh = make_mesh(cfg.mesh, None if dev.type == "cuda"
                                 else [dev] * cfg.mesh.num_devices)
        self._heads = [mesh.head(i) for i in range(len(mesh.devices))]
        super().__init__(index, cfg, device=next(h for h in self._heads if h is not None))
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
        self._row_mults = [None if h is None else _to(self._dix.mults, h) for h in self._heads]
        self._candidates_fn = self._exact_candidates
        self._sw_fn = self._verify_sharded

    def works_slices(self, stream: torch.Tensor) -> List[torch.Tensor | None]:
        """Works slice i of a batch's token stream on the first device of
        grid row i that this process owns (None where it owns none): its
        rows' tokens plus the (n - 1)-token halo (the next slice's head,
        the stream's tail for the last slice).  Every rank holds the
        whole stream, so the halo is a local slice."""
        n = self.cfg.shingle.n
        rows_l = (stream.shape[0] - n + 1) // self.mesh.shape[AXIS_WORKS]
        return [None if h is None else _to(stream[i * rows_l : (i + 1) * rows_l + n - 1], h)
                for i, h in enumerate(self._heads)]

    def _exact_candidates(self, stream: torch.Tensor, *, max_out: int):
        """K1 per works slice -> sharded K2 -> K3 compaction on the
        stream's device: ``compact_candidates``'s contract."""
        xcfg = self.cfg.search
        q_slices = []
        for h, ext_l, mults in zip(self._heads, self.works_slices(stream), self._row_mults):
            if h is None:
                q_slices.append(None)
                continue
            with _on(h):
                q_slices.append(embed_shingles(ext_l, mults))
        vals, idx = sharded_topk(self.mesh, q_slices, self._s_shards, self._ns_valid_shards,
                                 xcfg.k, min_keep=xcfg.candidate_threshold, out=self.device)
        return compact_candidates(vals, idx, xcfg.candidate_threshold,
                                  self.index.num_shingles, xcfg.k, max_out)

    def _verify_sharded(self, a, b, len_a, len_b, cfg):
        """``sw_normalized`` with the batch padded to works * 256 pairs
        (zero-length pairs) and split over the works devices: the cell
        (i, 0) of each works row scores its tile, wherever it is owned."""
        works = self.mesh.shape[AXIS_WORKS]
        bsz = a.shape[0]
        pad = (-bsz) % (works * VERIFY_TILE)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
            len_a = torch.nn.functional.pad(len_a, (0, pad))
            len_b = torch.nn.functional.pad(len_b, (0, pad))
        per = (bsz + pad) // works
        parts = {}
        for i, row in enumerate(self.mesh.devices):
            if self.mesh.local(i, 0):
                sl = slice(i * per, (i + 1) * per)
                dev = row[0]
                with _on(dev):
                    parts[(i, 0)] = (sw_normalized(_to(a[sl], dev), _to(b[sl], dev),
                                                   _to(len_a[sl], dev), _to(len_b[sl], dev),
                                                   cfg),)
        tiles = gather(self.mesh, [(i, 0) for i in range(works)], parts,
                       (((per,), torch.float32),), self.device)
        return _cat([t[0] for t in tiles])[:bsz]
