"""tokenize_idle_share.sweep: the share of the traced window, in %, in
which the cards were idle while the host waited on its tokenizer
threads: the idle gaps that fall in the engine's own
``host.tokenize_wait`` span (a part of ``host.batchgen``), mean over the
cards, over the window.  0 where the cards never waited so, and on a program
that predates the span (its traced run still ends).

layer: host batching (search/engine.py _work_stream, _batches, _flush)
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    if not ctx.trace or not ctx.trace.devices:
        return None
    return 100.0 * ctx.trace.gaps.get("host.tokenize_wait", 0.0) / ctx.trace.window_s
