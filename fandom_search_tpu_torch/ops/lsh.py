"""LSH prefilter: K6 Hamming top-R and the exact rerank; counterpart of fandom_search_tpu/ops/lsh.py.

Two-stage candidate generation that replaces the exact distance top-k
(K2) when attached to an engine (``attach_lsh_prefilter``):

  stage 1 — every shingle embedding is sketched into ``bits`` sign bits
    of a random +-1 projection (``encode``), packed 32 to a word, and
    ``hamming_topk`` keeps the ``rerank`` best script columns per query
    by similarity bits - 2 * popcount(q XOR s).  On CUDA tensors it
    launches ``csrc/hamming_topk.cu`` (K6, scores on the tensor cores);
    on CPU tensors it runs ``hamming_topk_plain``.
  stage 2 — ``rerank_exact`` re-scores those columns with the exact
    int8 dot and keeps the top k, as the JAX package's plain XLA code
    does (PyTorch ops here too: a gather, a batched f32 product, a
    top-k).

Codes travel as int32 bit patterns of the JAX package's uint32 words:
bit b of word w is projection column 32 * w + b, least significant bit
first, set when the projected score is >= 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from fandom_search_tpu_torch.config import LSHConfig, ShingleConfig
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops.distance_topk import NEG_INF, topk_lowest_col

# min_keep_sim that keeps every column: the exact top-R (the JAX
# package's _SENT)
SENT = -(1 << 30)
# the JAX package's packing holds bits <= 8192 (fandom_search_tpu/ops/lsh.py)
_KERNEL_MAX_BITS = 8192
# wider codes keep K6's row histogram in a device scratch of this many
# rows x (h_max + 1) bins (134 MB at 8,192 bits); the launch walks the
# rows in chunks of it
_WIDE_BITS = 2048
_SCRATCH_ROWS = 4096
_ENCODE_ROWS = 1 << 16   # rows per projection chunk (256 MB of f32 at 1024 bits)
# rerank score of a slot stage 1 left empty: below every exact dot
_EMPTY_SCORE = -(1 << 40)


def make_projection(cfg: LSHConfig, dim: int) -> np.ndarray:
    """Deterministic +-1 projection matrix [dim, bits] (int8)."""
    rng = np.random.default_rng(cfg.seed)
    return (rng.integers(0, 2, size=(dim, cfg.bits)) * 2 - 1).astype(np.int8)


def pack_sign_bits(scores: torch.Tensor) -> torch.Tensor:
    """[N, bits] scores -> int32 [N, bits // 32]: the packed sign bits."""
    n, bits = scores.shape
    b = (scores >= 0).reshape(n, bits // 32, 32).to(torch.int32)
    # int32 weight of each bit: 2^b, and -2^31 for bit 31, so a sum of
    # distinct bits never leaves the int32 range.  Made on the device:
    # a tensor copied from host memory would wait for the stream.
    shift = torch.arange(32, dtype=torch.int32, device=scores.device)
    w = torch.where(shift == 31, -(1 << 31), 2 ** shift.clamp(max=30))
    return (b * w).sum(dim=-1, dtype=torch.int32)


def encode(emb: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """int8 embeddings [N, D], +-1 projection [D, bits] -> int32 codes
    [N, bits // 32].

    An f32 product: every score is an integer of magnitude at most
    n * D (768 at the defaults), so it is exact in any summation order,
    as the JAX package's bf16 product with f32 accumulation is.  Rows
    go in chunks so the [rows, bits] scores stay small."""
    n = emb.shape[0]
    bits = projection.shape[1]
    proj = projection.float()
    out = torch.empty((n, bits // 32), dtype=torch.int32, device=emb.device)
    for r0 in range(0, n, _ENCODE_ROWS):
        r1 = min(n, r0 + _ENCODE_ROWS)
        out[r0:r1] = pack_sign_bits(emb[r0:r1].float() @ proj)
    return out


@dataclass
class LSHIndex:
    """The prefilter index over the script shingle matrix, on a device."""

    projection: torch.Tensor   # int8 [D, bits]
    codes_t: torch.Tensor      # int32 [W, NS_pad] — transposed packed codes
    ns_valid: int

    @classmethod
    def build(cls, s_emb: np.ndarray, cfg: LSHConfig, shingle_cfg: ShingleConfig,
              pad_multiple: int = 512, device="cuda") -> "LSHIndex":
        """Codes of the script rows, zero-padded to a multiple of
        ``pad_multiple`` rows (at least one multiple), like the JAX
        package's ``pad_rows``."""
        ns = s_emb.shape[0]
        s_pad = np.zeros((round_up_pad(ns, pad_multiple), shingle_cfg.dim), dtype=np.int8)
        s_pad[:ns] = s_emb
        proj = torch.from_numpy(make_projection(cfg, shingle_cfg.dim)).to(device)
        codes = encode(torch.from_numpy(s_pad).to(device), proj)
        return cls(projection=proj, codes_t=codes.T.contiguous(), ns_valid=int(ns))

    @classmethod
    def from_arrays(cls, projection: np.ndarray, codes_t: np.ndarray,
                    ns_valid: int) -> "LSHIndex":
        """An index on the CPU from saved arrays (int8 projection [D, bits],
        uint32 codes [W, NS_pad], the JAX package's dtypes); ``to`` moves
        it to a device."""
        proj = np.ascontiguousarray(projection, dtype=np.int8)
        codes = np.ascontiguousarray(codes_t, dtype=np.uint32).view(np.int32)
        return cls(projection=torch.from_numpy(proj), codes_t=torch.from_numpy(codes),
                   ns_valid=int(ns_valid))

    def to(self, device) -> "LSHIndex":
        return LSHIndex(projection=self.projection.to(device),
                        codes_t=self.codes_t.to(device), ns_valid=self.ns_valid)


def round_up_pad(n: int, multiple: int) -> int:
    """Rows after zero-padding n rows to a multiple of ``multiple`` (at
    least one multiple), like the JAX package's ``pad_rows``."""
    return max(multiple, -(-n // multiple) * multiple)


def _unpack_pm1(codes: torch.Tensor) -> torch.Tensor:
    """int32 codes [N, W] -> f32 [N, 32 * W] of +1 (bit set) / -1."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = (codes[:, :, None] >> shifts) & 1
    return (2 * bits - 1).reshape(codes.shape[0], -1).float()


def hamming_topk_plain(q_codes: torch.Tensor, codes_t: torch.Tensor,
                       ns_valid: int, rerank: int, bits: int,
                       min_keep_sim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the K6 kernel.

    sim = bits - 2 * hamming is the dot product of the two codes as +-1
    vectors, computed as an f32 matmul (exact: |sim| <= bits);
    ``topk_lowest_col`` selects.  Query rows are chunked so no more than
    ~64M keys exist at once."""
    nq = q_codes.shape[0]
    dev = q_codes.device
    vals = torch.full((nq, rerank), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((nq, rerank), dtype=torch.int32, device=dev)
    ns = int(ns_valid)
    if nq == 0 or ns == 0:
        return vals, idx
    s_pm = _unpack_pm1(codes_t[:, :ns].T.contiguous()).T.contiguous()  # [bits, ns]
    chunk = max(1, (1 << 26) // max(ns, rerank))
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        sim = (_unpack_pm1(q_codes[q0:q1]) @ s_pm).long()
        sc, col, empty = topk_lowest_col(sim, sim >= min_keep_sim, rerank)
        vals[q0:q1] = torch.where(empty, NEG_INF, sc.float())
        idx[q0:q1] = torch.where(empty, 0, col).int()
    return vals, idx


_MMA_ROUTES = {"s8": 0, "b1": 1}
# the K6 route the engine takes where bits allow it: on an H100 the 1-bit
# product ran the engine's gated 2^20-row batch in a third of the s8
# route's time (PERF.md, chip_smoke.py's K6 phase)
DEFAULT_MMA = "b1"


def hamming_topk(q_codes: torch.Tensor, codes_t: torch.Tensor, ns_valid: int,
                 rerank: int, bits: int, *, min_keep_sim: int = SENT,
                 mma: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 codes q [NQ, W] against codes_t [W, NS_pad] -> (f32 sim
    [NQ, R], int32 column [NQ, R]).

    Per query row, the top R columns in [0, ns_valid) by sim = bits -
    2 * popcount(q XOR s), sim descending, then column ascending; empty
    slots are (NEG_INF, 0).  ``min_keep_sim`` declares that the caller
    discards columns whose sim is below it: only columns with sim >=
    min_keep_sim enter, so a row holds padding where the JAX kernel,
    whose gate works per tile, may hold sub-threshold entries; its
    entries at or above the threshold are exactly these.

    ``mma`` picks the CUDA kernel's tensor-core product: "s8" (0/1 bytes,
    any bits) or "b1" (1-bit AND-popc on the packed words, bits a
    multiple of 256); both give the same outputs.  None takes
    ``DEFAULT_MMA`` where bits allow it, else "s8".
    """
    if mma is None:
        mma = DEFAULT_MMA if bits % 256 == 0 else "s8"
    _cuda.require(bits > 0 and bits % 32 == 0,
                  f"bits ({bits}) must be a positive multiple of 32")
    words = bits // 32
    _cuda.require(q_codes.dtype == torch.int32 and q_codes.dim() == 2
                  and q_codes.shape[1] == words,
                  f"q_codes must be int32 [NQ, {words}], got {q_codes.dtype} "
                  f"{tuple(q_codes.shape)}")
    _cuda.require(codes_t.dtype == torch.int32 and codes_t.dim() == 2
                  and codes_t.shape[0] == words,
                  f"codes_t must be int32 [{words}, NS], got {codes_t.dtype} "
                  f"{tuple(codes_t.shape)}")
    _cuda.require(0 <= ns_valid <= codes_t.shape[1],
                  f"ns_valid ({ns_valid}) must lie in [0, {codes_t.shape[1]}]")
    _cuda.require(rerank >= 1, f"rerank ({rerank}) must be >= 1")
    _cuda.require(mma in _MMA_ROUTES and (mma != "b1" or bits % 256 == 0),
                  f"mma must be 's8', or 'b1' with bits a multiple of 256; got "
                  f"{mma!r} at bits {bits}")
    if _cuda.on_cpu(q_codes, codes_t):
        return hamming_topk_plain(q_codes, codes_t, ns_valid, rerank, bits,
                                  min_keep_sim)
    _cuda.require(bits <= _KERNEL_MAX_BITS,
                  f"the CUDA kernel takes bits <= {_KERNEL_MAX_BITS}, got {bits}")
    _cuda.require(q_codes.is_contiguous() and codes_t.is_contiguous(),
                  "q_codes and codes_t must be contiguous")
    nq = q_codes.shape[0]
    vals = torch.empty((nq, rerank), dtype=torch.float32, device=q_codes.device)
    idx = torch.empty((nq, rerank), dtype=torch.int32, device=q_codes.device)
    if nq == 0:
        return vals, idx
    # sim >= min_keep_sim  <=>  hamming <= (bits - min_keep_sim) / 2
    h_max = max(-1, min(bits, (bits - int(min_keep_sim)) // 2))
    scratch, scratch_rows, launches = None, 0, 1
    if bits > _WIDE_BITS:
        # one launch per chunk of scratch_rows rows
        scratch_rows = min(_SCRATCH_ROWS, -(-nq // 64) * 64)
        launches = -(-nq // scratch_rows)
        scratch = torch.empty((scratch_rows * max(1, h_max + 1),), dtype=torch.int32,
                              device=q_codes.device)
    lib = _cuda.library()
    rc = lib.fs_hamming_topk(
        q_codes.data_ptr(), codes_t.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), scratch_rows,
        nq, words, codes_t.shape[1], int(ns_valid), rerank, bits, h_max,
        _MMA_ROUTES[mma], _cuda.stream_ptr(q_codes.device),
    )
    _cuda.check(rc, "fs_hamming_topk")
    hamming_topk.launches += launches
    return vals, idx


hamming_topk.launches = 0


def rerank_exact(q_emb: torch.Tensor, s_emb: torch.Tensor,
                 cand_idx: torch.Tensor, cand_ok: torch.Tensor, k: int,
                 dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of the stage-1 survivors: int8 q [NQ, D], script rows
    s [NS, D] (any dtype; pass f32 to skip a conversion per call),
    int32 candidates [NQ, R] with their validity [NQ, R] -> (f32 dot / dim
    [NQ, k], int32 script row [NQ, k]).

    Ties in the exact score go to the lowest position in the R-list
    (``lax.top_k``'s rule), not to the lowest script row; invalid slots
    score NEG_INF and keep their stage-1 row.  Rows go in chunks so
    the gathered f32 block stays under 1 GB."""
    nq, r = cand_idx.shape
    dev = q_emb.device
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    s_f = s_emb.float()
    keep_all = torch.ones((1, r), dtype=torch.bool, device=dev)
    chunk = max(1, (1 << 28) // max(1, r * dim))
    for r0 in range(0, nq, chunk):
        r1 = min(nq, r0 + chunk)
        ci = cand_idx[r0:r1].long()
        dots = torch.bmm(s_f[ci], q_emb[r0:r1].float()[:, :, None])[:, :, 0]
        score = torch.where(cand_ok[r0:r1], dots.long(), _EMPTY_SCORE)
        sc, pos, _ = topk_lowest_col(score, keep_all.expand(r1 - r0, r), k)
        vals[r0:r1] = torch.where(sc == _EMPTY_SCORE, NEG_INF, sc.float() / dim)
        idx[r0:r1] = torch.gather(ci, 1, pos).int()
    return vals, idx


def coarse_sim_threshold(candidate_threshold: float, n: int, bits: int,
                         sigmas: float = 6.0) -> int:
    """Hamming-similarity floor equivalent to the engine's candidate
    threshold, minus a ``sigmas`` safety margin of code noise.

    A candidate with m matching words of n has expected similarity
    bits*(1 - 2*acos(m/n)/pi) with sd 2*sqrt(bits*p*(1-p)); anything
    the engine could keep sits ``sigmas`` deviations above this floor."""
    ct = min(max(candidate_threshold / n, 0.0), 1.0)
    p = math.acos(ct) / math.pi
    mean_sim = bits * (1.0 - 2.0 * p)
    sigma = 2.0 * math.sqrt(bits * p * (1.0 - p))
    return max(int(mean_sim - sigmas * sigma), -bits)


def lsh_topk(q_emb: torch.Tensor, lsh: LSHIndex, s_emb: torch.Tensor, k: int,
             dim: int, cfg: LSHConfig, *,
             min_keep_sim: int = SENT) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: Hamming prefilter (K6) -> exact rerank."""
    q_codes = encode(q_emb, lsh.projection)
    vals1, idx1 = hamming_topk(q_codes, lsh.codes_t, lsh.ns_valid, cfg.rerank,
                               cfg.bits, min_keep_sim=min_keep_sim)
    return rerank_exact(q_emb, s_emb, idx1, vals1 > NEG_INF / 2, k, dim)


def attach_lsh_prefilter(engine, cfg: LSHConfig, lsh: LSHIndex | None = None) -> None:
    """Swap a SearchEngine's candidate stage for the LSH pipeline: K1
    embed -> encode -> K6 -> rerank -> threshold compaction, on the
    engine's device.  The rest of the engine's device step (dedup,
    windows, verification) stays as it is.

    ``lsh`` may be a prebuilt index (e.g. ``search/persist.py``'s
    ``load_lsh``); it must match the engine's script index and pad
    multiple, which is checked by shape, and is moved to the engine's
    device.  Without it the codes are built here."""
    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.engine import compact_candidates

    if engine.cfg.search.k > cfg.rerank:
        raise ValueError(
            f"k ({engine.cfg.search.k}) cannot exceed the LSH rerank "
            f"width ({cfg.rerank}): stage 2 re-scores only rerank "
            f"candidates per query — raise rerank or lower --k"
        )
    scfg, xcfg = engine.cfg.shingle, engine.cfg.search
    dix = engine._dix
    if lsh is not None:
        ns_pad = round_up_pad(engine.index.num_shingles, xcfg.script_pad_multiple)
        if (int(lsh.ns_valid) != engine.index.num_shingles
                or tuple(lsh.codes_t.shape) != (cfg.bits // 32, ns_pad)):
            raise ValueError(
                "persisted LSH index does not match the script index "
                f"(codes {tuple(lsh.codes_t.shape)}, ns_valid {lsh.ns_valid} "
                f"vs expected ({cfg.bits // 32}, {ns_pad}), "
                f"{engine.index.num_shingles}) — rebuild with "
                "`python -m fandom_search_tpu_torch index --lsh`"
            )
        lsh = lsh.to(engine.device)
    else:
        lsh = LSHIndex.build(engine.index.embeddings, cfg, scfg,
                             pad_multiple=xcfg.script_pad_multiple,
                             device=engine.device)
    engine.lsh = lsh
    s_emb_f = dix.s_emb.float()
    ns_true = engine.index.num_shingles
    # the engine only keeps candidates >= candidate_threshold: gate the
    # Hamming kernel on the equivalent similarity floor (6-sigma slack)
    keep_sim = coarse_sim_threshold(xcfg.candidate_threshold, scfg.n, cfg.bits)

    def candidates(stream, *, max_out):
        q_emb = embed_shingles(stream, dix.mults)
        vals, idx = lsh_topk(q_emb, lsh, s_emb_f, xcfg.k, scfg.dim, cfg,
                             min_keep_sim=keep_sim)
        return compact_candidates(vals, idx, xcfg.candidate_threshold,
                                  ns_true, xcfg.k, max_out)

    engine._candidates_fn = candidates
    engine._k2_on_stream = False
    # uploads go raw, as on the JAX engine's two-stage prefilter flow
    engine._venc = None
