"""k2_roofline.sweep: K2's share of its roofline, in %: the least time
of every K2 call in the traced window (the larger of 2 * NQ * NS * dim
int8 operations over the int8 peak and the bytes read and written once
over the HBM rate: harness/roofline.py) over K2's device time in the
trace.  NQ is the query rows the algorithm needs (harness/trace.py): a
batch's work shingles, or on the bucketed hybrid those among its at-risk
rows; a launch that reruns a batch after a budget overflow adds its time
and no bound.

layer: candidate stage, exact (ops/distance_topk.py, csrc/distance_topk.cu)
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    calls = ctx.trace.k2 if ctx.trace else []
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(t for _, t in calls)
