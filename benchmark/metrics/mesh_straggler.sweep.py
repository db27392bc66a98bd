"""mesh_straggler.sweep: how far the busiest card of a mesh runs ahead
of the others, in %: the busiest card's busy seconds in the traced
window over the mean busy seconds of the mesh's cards, minus 1.  Reads
nothing on one card.

layer: mesh (parallel/sharded.py, parallel/comm.py)
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    busy = list(ctx.trace.busy_s.values()) if ctx.trace else []
    if len(busy) < 2 or not sum(busy):
        return None
    return 100.0 * (max(busy) * len(busy) / sum(busy) - 1.0)
