"""k4_roofline.sweep: K4's share of its roofline, in %: the least time of
every K4 call in the traced window (the DP cells its pairs' lengths need
at the packed route's instructions a cell over the integer issue rate,
or the bytes over the HBM rate if larger: harness/roofline.py) over
K4's device time in the trace.

layer: verify (search/engine.py verify_pairs, ops/smith_waterman.py, csrc/smith_waterman.cu)
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    calls = ctx.trace.k4 if ctx.trace else []
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(t for _, t in calls)
