"""bucket_stage_device_share.sweep: the share of the traced window, in %,
that the card spent in the bucketed hybrid's stage 1 (probe geometry,
segment stream, gather-dot, sort, compaction, at-risk row compaction and
merge; not K2 on the at-risk rows): the engine's ``d_bucket_stage``
(CUDA event pairs around the ``stage.bucket`` parts while tracing)
summed over the window's calls, over the window.  A program that
predates the span (no call carries the engine's ``s_pack``) reads 0, so
that a traced run of it still ends; one that has it and lost it reads
nothing, and the run fails.

layer: candidate stage, bucketed (ops/bucketed.py hybrid)
source: program_span; moves: search_words_per_s
"""


def read(ctx):
    if not any("s_pack" in c["extra"] for c in ctx.calls):
        return 0.0
    d = [c["extra"]["d_bucket_stage"] for c in ctx.calls if "d_bucket_stage" in c["extra"]]
    return 100.0 * sum(d) / ctx.window_s if d else None
