"""k2_pad_share.sweep: the share, in %, of the query rows K2 computed
that the algorithm did not need: 1 - the engine's ``k2_rows_needed``
over its ``k2_rows_launched``, summed over the window's calls.  On the
bucketed hybrid K2 runs on the sticky at-risk budget; the rows needed
are the at-risk rows of each batch's first launch that start a shingle
inside one work (counted on the device while tracing), and a rerun
after a budget overflow adds launched rows only.  A program that
predates the counters (no call carries the engine's ``s_pack``) reads 0,
so that a traced run of it still ends; one that has them and lost them
reads nothing, and the run fails.

layer: candidate stage, bucketed (ops/bucketed.py hybrid)
source: program_counter; moves: search_words_per_s
"""


def read(ctx):
    if not any("s_pack" in c["extra"] for c in ctx.calls):
        return 0.0
    calls = [c["extra"] for c in ctx.calls if "k2_rows_needed" in c["extra"]]
    launched = sum(x.get("k2_rows_launched", 0.0) for x in calls)
    if not launched:
        return None
    return 100.0 * (1.0 - sum(x["k2_rows_needed"] for x in calls) / launched)
