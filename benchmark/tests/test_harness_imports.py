"""Nothing the benchmark runs may be JAX or the JAX package, compared by
whole top-level names; the plain reference imports nothing of the
program."""

import ast
from pathlib import Path

from benchmark.harness.imports import forbidden

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert forbidden(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden(["fandom_search_tpu.search.engine"]) == ["fandom_search_tpu"]
    # the port's name begins with the JAX package's: a prefix match would flag it
    assert forbidden(["fandom_search_tpu_torch", "fandom_search_tpu_torch.ops.embed",
                      "jaxtyping", "flaxen", "numpy"]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_benchmark_file_imports_jax():
    for f in BENCH.rglob("*.py"):
        assert forbidden(_imports(f)) == [], f


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"fandom_search_tpu_torch", "fandom_search_tpu", "benchmark"}, f
        assert tops <= {"__future__", "re", "dataclasses", "typing", "numpy", "torch"}, (f, tops)


def test_run_in_a_process_loads_no_jax(tiny_bench):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); from benchmark.harness import runner; "
            "runner.run('tiny.tiny', 5, 0.1, False, device='cpu', bench_json=%r); "
            "from benchmark.harness.imports import forbidden_modules; "
            "print('FOUND', forbidden_modules())") % (str(BENCH.parent), str(tiny_bench))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout
