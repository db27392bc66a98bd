"""batchgen_share.sweep: the share of the traced window, in %, that the
host spent generating batches: the engine's ``s_batchgen`` (tokenizing
and packing, with the wait on its tokenizer threads) summed over the
window's calls, over the window.

layer: host batching (search/engine.py _work_stream, _batches, _flush)
source: program_span; moves: search_words_per_s
"""


def read(ctx):
    return 100.0 * sum(c["extra"].get("s_batchgen", 0.0) for c in ctx.calls) / ctx.window_s
