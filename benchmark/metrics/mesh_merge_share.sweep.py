"""mesh_merge_share.sweep: the share of the traced window, in %, that the
stream's card spent on the mesh's exchange and exact merge: the device
time of the kernels and copies launched inside the ``bench.gather``
spans (``comm.gather``: the blocks' top-k lists and the verify tiles
copied to the stream's card) and the ``bench.merge`` spans
(``merge_topk``), that ran on the stream's card or, as peer copies,
landed there, over the window.

layer: mesh (parallel/sharded.py, parallel/comm.py)
source: device_trace; moves: search_words_per_s
"""


def read(ctx):
    if not ctx.trace or not ctx.trace.exchange_s:
        return None
    return 100.0 * ctx.trace.exchange_s / ctx.trace.window_s
