"""fandom_search_tpu_torch — the PyTorch/CUDA port of fandom_search_tpu.

The exact search path (embed -> int8 distance top-k -> compaction ->
Smith-Waterman verify -> chaining) runs on an NVIDIA GPU through four
hand-written CUDA kernels (``csrc/``), each with a plain PyTorch twin
that the CPU tests hold against the JAX package.  Configs are imported
from ``fandom_search_tpu.config``, which is free of JAX.
"""

from fandom_search_tpu.config import (  # noqa: F401
    PipelineConfig,
    SearchConfig,
    ShingleConfig,
)
