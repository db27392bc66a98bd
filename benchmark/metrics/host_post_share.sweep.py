"""host_post_share.sweep: the share of the traced window, in %, that the
host spent on a batch's hits after the pull and on chaining them into
rows: the engine's ``s_host`` summed over the window's calls, over the
window.

layer: host post-processing and chaining (search/engine.py _process_fused tail, search/chain.py)
source: program_span; moves: search_words_per_s
"""


def read(ctx):
    return 100.0 * sum(c["extra"].get("s_host", 0.0) for c in ctx.calls) / ctx.window_s
