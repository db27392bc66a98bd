"""Index persistence; counterpart of fandom_search_tpu/search/persist.py.

``save_index`` writes a script index once (``index`` verb) so later
``search --index`` and ``serve --index`` runs skip parsing and
embedding the script; ``save_lsh`` adds the LSH prefilter's projection
and codes beside it, ``save_bucketed`` the bucketed prefilter's tables.
``meta.json``, ``lsh_meta.json`` and ``bucketed_meta.json`` follow the
JAX package's schema (format version 3, the same config fields and line
records) and the arrays keep its dtypes (uint32 hashes and windows,
int8 embeddings, int8 projection, uint32 codes, int32 tables).

The arrays go to ``arrays.npz``, ``lsh_arrays.npz`` and
``bucketed_arrays.npz`` (``np.savez``, read back with
``allow_pickle=False``).  The JAX package writes them as orbax
checkpoints (``arrays/``, ``lsh_arrays/``, ...), which this package
does not read: a directory that holds ``arrays/`` and no ``arrays.npz``
is refused with a message to re-run this package's ``index``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np

from fandom_search_tpu_torch.config import (
    BucketedConfig,
    LSHConfig,
    PipelineConfig,
    SearchConfig,
    ShingleConfig,
)
from fandom_search_tpu_torch.data.script_parser import ScriptLine
from fandom_search_tpu_torch.data.tokenizer import tokenize
from fandom_search_tpu_torch.search.index import ScriptIndex

_VERSION = 3  # v3: multiply-shift sign embedding (v2 indices must rebuild)

_ARRAY_FIELDS = (
    "stream_hashes",
    "token_line",
    "shingle_line",
    "shingle_anchor",
    "shingle_windows",
    "embeddings",
    "line_start",
    "line_lengths",
)
_REINDEX = "python -m fandom_search_tpu_torch index"


def save_index(index: ScriptIndex, cfg: PipelineConfig, path: str | Path) -> None:
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "arrays.npz",
             **{f: np.asarray(getattr(index, f)) for f in _ARRAY_FIELDS})
    meta = {
        "version": _VERSION,
        "lines": [
            {"line_no": ln.line_no, "speaker": ln.speaker, "text": ln.text,
             "script": ln.script}
            for ln in index.lines
        ],
        "shingle": dataclasses.asdict(cfg.shingle),
        "search": dataclasses.asdict(cfg.search),
        "lsh": dataclasses.asdict(cfg.lsh),
        "bucketed": dataclasses.asdict(cfg.bucketed),
    }
    (path / "meta.json").write_text(json.dumps(meta), encoding="utf-8")


def _read_npz(path: Path, name: str, fields) -> dict:
    npz = path / f"{name}.npz"
    if not npz.exists():
        if (path / name).is_dir():
            raise ValueError(
                f"{path} holds an orbax checkpoint ({name}/), written by the "
                f"JAX package; this package reads {name}.npz — re-run "
                f"`{_REINDEX}` on the script(s) to write one"
            )
        raise FileNotFoundError(f"{npz} not found — build it with `{_REINDEX}`")
    with np.load(npz, allow_pickle=False) as z:
        return {f: z[f] for f in fields}


def load_index(path: str | Path) -> Tuple[ScriptIndex, PipelineConfig]:
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text(encoding="utf-8"))
    if meta.get("version") != _VERSION:
        raise ValueError(
            f"index at {path} is format v{meta.get('version')}; this build "
            f"reads v{_VERSION} — rebuild it with `{_REINDEX}`"
        )
    arrays = _read_npz(path, "arrays", _ARRAY_FIELDS)
    lines = [
        ScriptLine(d["line_no"], d["speaker"], d["text"], d.get("script", ""))
        for d in meta["lines"]
    ]
    index = ScriptIndex(
        lines=lines,
        tokenized=[tokenize(ln.text) for ln in lines],
        **arrays,
    )
    cfg = PipelineConfig(
        shingle=ShingleConfig(**meta["shingle"]),
        search=SearchConfig(**meta["search"]),
        lsh=LSHConfig(**meta["lsh"]),
        bucketed=BucketedConfig(**meta.get("bucketed") or {}),
    )
    return index, cfg


def save_lsh(path: str | Path, lsh, cfg: LSHConfig) -> None:
    """Persist a built LSHIndex (``ops/lsh.py``) next to the script index:
    its projection and packed transposed codes, so attaching the
    prefilter to a loaded index builds nothing and is bit-identical."""
    path = Path(path).resolve()
    np.savez(
        path / "lsh_arrays.npz",
        projection=lsh.projection.cpu().numpy(),
        codes_t=lsh.codes_t.cpu().numpy().view(np.uint32),
    )
    meta = {
        "ns_valid": int(lsh.ns_valid),
        "lsh": dataclasses.asdict(cfg),
    }
    (path / "lsh_meta.json").write_text(json.dumps(meta), encoding="utf-8")


def load_lsh(path: str | Path, cfg: LSHConfig):
    """Load a persisted LSHIndex (on the CPU; ``attach_lsh_prefilter``
    moves it to the engine's device); None if absent or config-mismatched
    (a mismatch means the caller wants different bits/seed — rebuild)."""
    from fandom_search_tpu_torch.ops.lsh import LSHIndex

    path = Path(path).resolve()
    meta_path = path / "lsh_meta.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    if meta.get("lsh") != dataclasses.asdict(cfg):
        return None
    arrays = _read_npz(path, "lsh_arrays", ("projection", "codes_t"))
    return LSHIndex.from_arrays(arrays["projection"], arrays["codes_t"],
                                int(meta["ns_valid"]))


def _bucketed_identity(cfg: BucketedConfig) -> dict:
    """The BucketedConfig fields that determine the built tables:
    ``hybrid`` is a routing choice at search time, and the same tables
    serve both modes."""
    d = dataclasses.asdict(cfg)
    d.pop("hybrid", None)
    return d


def save_bucketed(path: str | Path, bidx, cfg: BucketedConfig) -> None:
    """Persist a built BucketedIndex (``ops/bucketed.py``) next to the
    script index, so attaching the prefilter to a loaded index builds
    nothing."""
    path = Path(path).resolve()
    np.savez(
        path / "bucketed_arrays.npz",
        entries=bidx.entries.cpu().numpy(),
        offsets=bidx.offsets.cpu().numpy(),
    )
    meta = {
        "num_buckets": int(bidx.num_buckets),
        "salts": list(bidx.salts),
        "ns_valid": int(bidx.ns_valid),
        "overflow_frac": float(bidx.overflow_frac),
        "bucketed": _bucketed_identity(cfg),
    }
    (path / "bucketed_meta.json").write_text(json.dumps(meta), encoding="utf-8")


def load_bucketed(path: str | Path, cfg: BucketedConfig):
    """Load a persisted BucketedIndex (on the CPU;
    ``attach_bucketed_prefilter`` moves it to the engine's device); None
    if absent, or, with a warning, if built with another config."""
    import sys

    from fandom_search_tpu_torch.ops.bucketed import BucketedIndex

    path = Path(path).resolve()
    meta_path = path / "bucketed_meta.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    saved = dict(meta.get("bucketed") or {})
    saved.pop("hybrid", None)  # saves from before the field existed
    if saved != _bucketed_identity(cfg):
        print(
            f"warning: persisted bucketed tables at {path} were built "
            f"with {saved}, requested {_bucketed_identity(cfg)}; "
            f"rebuilding from the requested config",
            file=sys.stderr,
        )
        return None
    arrays = _read_npz(path, "bucketed_arrays", ("entries", "offsets"))
    return BucketedIndex.from_arrays(
        arrays["entries"], arrays["offsets"], int(meta["num_buckets"]),
        meta["salts"], int(meta["ns_valid"]), float(meta["overflow_frac"]),
    )
