"""pull_wait_share.sweep: the share of the traced window, in %, that the
host waited to pull a batch's result from the card: the engine's
``s_pull`` summed over the window's calls, over the window.  High means
the host waits for the card.

layer: pull (search/engine.py _process_fused)
source: program_span; moves: search_words_per_s
"""


def read(ctx):
    return 100.0 * sum(c["extra"].get("s_pull", 0.0) for c in ctx.calls) / ctx.window_s
