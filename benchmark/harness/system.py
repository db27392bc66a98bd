"""The system under test, built from a configuration file: the script
index, the engine (over a works x script grid of cards where the
configuration has a ``mesh`` section, as ``search --mesh WxS`` builds
it) and its prefilter (``"prefilter": "bucketed"`` or ``"lsh"``, as
``search --bucketed`` and ``search --lsh`` attach them).  This module
and ``trace.py`` (the traced run's spans) are the harness's only imports
of the program."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from fandom_search_tpu_torch import config as pconfig
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.ops.bucketed import attach_bucketed_prefilter
from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
from fandom_search_tpu_torch.search.engine import SearchEngine
from fandom_search_tpu_torch.search.index import build_script_index

_SECTIONS = {
    "shingle": pconfig.ShingleConfig, "search": pconfig.SearchConfig,
    "lsh": pconfig.LSHConfig, "bucketed": pconfig.BucketedConfig, "mesh": pconfig.MeshConfig,
}
# prefilter name -> its attach, called with the pipeline section of the
# same name and no prebuilt tables, so that set-up builds them
_PREFILTERS = {"bucketed": attach_bucketed_prefilter, "lsh": attach_lsh_prefilter}


def pipeline_config(pipeline: dict) -> pconfig.PipelineConfig:
    """The port's PipelineConfig with the configuration's fields set."""
    unknown = set(pipeline) - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown pipeline sections {sorted(unknown)}")
    return pconfig.PipelineConfig(**{
        name: cls(**pipeline.get(name, {})) for name, cls in _SECTIONS.items()})


def load_kernels(device: str) -> float:
    """Seconds to load (on a checkout's first run: build) the kernels
    and the native tokenizer."""
    t0 = time.perf_counter()
    from fandom_search_tpu_torch.data import fast_tokenizer

    fast_tokenizer.get_lib()
    if device.startswith("cuda"):
        from fandom_search_tpu_torch.ops import _cuda

        _cuda.library()
    return time.perf_counter() - t0


def build_engine(script_text: str, config: dict, device: str, phases: Dict[str, float]):
    """The engine over the index built from the script text, with the
    configuration's prefilter attached; ``phases`` gets each step's
    seconds.  A mesh of more than one cell gives a
    ``ShardedSearchEngine``, as the CLI's ``_build_engine`` chooses."""
    cfg = pipeline_config(config.get("pipeline", {}))
    t0 = time.perf_counter()
    index = build_script_index(parse_script(script_text), cfg.shingle, cfg.search)
    phases["index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cfg.mesh.num_devices > 1:
        from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine

        engine = ShardedSearchEngine(index, cfg, device=device)
    else:
        engine = SearchEngine(index, cfg, device=device)
    phases["engine"] = time.perf_counter() - t0
    prefilter = config.get("prefilter")
    if prefilter is not None:
        if prefilter not in _PREFILTERS:
            raise ValueError(f"unknown prefilter {prefilter!r}; have {sorted(_PREFILTERS)}")
        t0 = time.perf_counter()
        _PREFILTERS[prefilter](engine, getattr(cfg, prefilter))
        phases[f"{prefilter}_tables"] = time.perf_counter() - t0
    return engine


def engine_devices(engine) -> List[torch.device]:
    """The devices the engine runs on, the stream's first: its grid's
    distinct devices in grid order, or its one device."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return [engine.device]
    return list(dict.fromkeys(d for row in mesh.devices for d in row))
