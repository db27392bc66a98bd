"""fandom_search_tpu_torch — the PyTorch/CUDA port of fandom_search_tpu.

The exact search path (embed -> int8 distance top-k -> compaction ->
Smith-Waterman verify -> chaining), the LSH prefilter path and the
bucketed prefilter path run on an NVIDIA GPU through hand-written CUDA kernels (``csrc/``), each with a
plain PyTorch twin that the CPU tests hold against the JAX package.
The CLI's ``index``, ``search`` (``--index``, ``--resume-dir``,
``--parquet``, ``--profile``), ``serve`` and ``matrix --html`` verbs run
on top of it.  The package imports nothing of ``fandom_search_tpu``: it
keeps its own copies of the config and of the works-directory loader.
"""

from fandom_search_tpu_torch.config import (  # noqa: F401
    BucketedConfig,
    LSHConfig,
    PipelineConfig,
    SearchConfig,
    ShingleConfig,
)
