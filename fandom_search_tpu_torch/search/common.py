"""Verify-window helpers; counterpart of fandom_search_tpu/search/common.py."""

from __future__ import annotations

from fandom_search_tpu.config import SearchConfig, ShingleConfig


def verify_window(
    fan_pos: int,
    num_tokens: int,
    shingle_cfg: ShingleConfig,
    search_cfg: SearchConfig,
) -> tuple[int, int]:
    """Token range [start, end) of the fan-side verification window.

    The window is ``window_tokens`` wide when the work allows, centered
    on the candidate shingle so a quote of up to ~window length around
    the shingle is fully visible to the aligner.
    """
    w = search_cfg.window_tokens
    lead = (w - shingle_cfg.n) // 2
    start = min(max(0, fan_pos - lead), max(0, num_tokens - w))
    end = min(num_tokens, start + w)
    return start, end


def line_segment(anchor, line_len, shingle_cfg, search_cfg):
    """Token range (start, length) of the line-side verification segment.

    Long script lines are NOT truncated: verification reads a
    ``max_line_tokens``-wide segment of the line centered on the matched
    shingle's position (``anchor``), the mirror of ``verify_window`` on
    the fan side, so a quote of any region of a long monologue line
    verifies against exactly that region.  Lines shorter than the
    segment width behave as before (whole line).  Works on scalars and
    NumPy arrays alike.
    """
    import numpy as np

    mlt = search_cfg.max_line_tokens
    lead = (mlt - shingle_cfg.n) // 2
    b0 = np.minimum(
        np.maximum(0, anchor - lead), np.maximum(0, line_len - mlt)
    )
    len_b = np.minimum(line_len - b0, mlt)
    return b0, len_b
