"""device.idle_share.sweep: the share of the traced window, in %, in
which no kernel, copy or memset ran on a card, averaged over the cards.

layer: device
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    if not ctx.trace or not ctx.trace.devices or not ctx.trace.mean_busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.mean_busy_s / ctx.trace.window_s)
