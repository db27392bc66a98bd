"""The system under test as the configuration names it: an ``lsh``
prefilter gives the engine that ``search --lsh`` builds, and a prefilter
the harness does not know is refused."""

import argparse

import pytest
import torch

from benchmark.harness import cells, system, world
from conftest import TINY_CELL, add_tiny_cell
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.data.script_parser import parse_script
from fandom_search_tpu_torch.search.index import build_script_index


def _tiny(tmp_path, prefilter=None):
    cell = cells.load_cell(TINY_CELL, add_tiny_cell(tmp_path, prefilter=prefilter))
    vocab, script, ranks = world.make_script_world(37, cell.config["script"])
    return cell, script, world.make_pool(37, vocab, script, ranks, cell.traffic)


def test_lsh_engine_is_the_one_search_lsh_builds(tmp_path):
    """Equal codes and projection, the LSH candidate stage in place of
    K2, and equal rows on the tiny world."""
    cell, script, pool = _tiny(tmp_path, prefilter="lsh")
    phases = {}
    ours = system.build_engine(script.text, cell.config, "cpu", phases)
    cfg = system.pipeline_config(cell.config["pipeline"])
    index = build_script_index(parse_script(script.text), cfg.shingle, cfg.search)
    args = argparse.Namespace(lsh=True, bucketed=False, index=None)
    theirs = cli._build_engine(args, cfg, index, "cpu")
    assert "lsh_tables" in phases and cfg.lsh == type(cfg.lsh)()
    assert torch.equal(ours.lsh.codes_t, theirs.lsh.codes_t)
    assert torch.equal(ours.lsh.projection, theirs.lsh.projection)
    assert ours.lsh.ns_valid == theirs.lsh.ns_valid == index.num_shingles
    assert not ours._k2_on_stream and not theirs._k2_on_stream
    works = world.call_works(pool, 1)
    rows, _ = ours.search_works(works)
    want, _ = theirs.search_works(works)
    assert rows and rows == want


def test_unknown_prefilter_is_refused(tmp_path):
    cell, script, _ = _tiny(tmp_path)
    with pytest.raises(ValueError, match="unknown prefilter 'nope'"):
        system.build_engine(script.text, {**cell.config, "prefilter": "nope"}, "cpu", {})
