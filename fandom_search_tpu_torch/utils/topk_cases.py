"""Edge cases of the int8 distance top-k (K2 and K7, ``ops/distance_topk.py``).

One small world, made from a seed, holds the inputs on which the CUDA
designs could go wrong; the CPU tests hold the plain version to the JAX
op on it, and ``chip_smoke.py`` holds both kernels to the plain version
on it, every slot.  The kernels walk the script in ring tiles of
``TILE`` rows and epilogue steps of ``STEP`` columns, 256 query rows a
block, and keep at most ``STEP`` gate-passing entries a row per step.
"""

from __future__ import annotations

import numpy as np

DIM = 128
STEP = 32
TILE = 64
# ns_valid: none, one, around a step's and a tile's edge, and ragged
NS_VALID = (0, 1, STEP - 1, STEP, STEP + 1, TILE - 1, TILE, TILE + 1, 3001)
KS = (1, 10, 16, 17, 32)
MIN_KEEP = 3.5  # the engine's candidate threshold
NQ = 300        # not a multiple of a block's 256 rows
NS = 3100


def edge_world(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(q int8 [NQ, DIM], s int8 [NS, DIM]), values in [-6, 6]:

    - rows 0-3 of q planted in s on both sides of a step edge (31/32), a
      tile edge (63/64, 127/128) and far apart (1023/1024): equal scores
      across an edge;
    - q[4] planted 11 times inside one tile (200-209, 230), q[5] 40 times
      in a row (400-439, more than a step holds): equal scores inside a
      tile and across steps;
    - q[100:] all equal to q[6] (the padding case: identical rows), which
      s holds 100 times in a row (1000-1099), 100 times every other row
      (2000-2198), 40 times with one coordinate changed (1500-1539,
      distinct scores above the threshold), twice late with a higher score
      (2500, 2999: the top changes after the gate has risen), and again
      past ns_valid 3001 (3001-3099, which must never enter).
    """
    rng = np.random.default_rng(seed)
    q = rng.integers(-6, 7, size=(NQ, DIM)).astype(np.int8)
    s = rng.integers(-6, 7, size=(NS, DIM)).astype(np.int8)
    for i, cols in enumerate(((31, 32), (63, 64), (127, 128), (1023, 1024))):
        s[list(cols)] = q[i]
    s[200:210] = q[4]
    s[230] = q[4]
    s[400:440] = q[5]
    z = q[6]
    q[100:] = z
    s[1000:1100] = z
    s[2000:2200:2] = z
    for i in range(40):
        s[1500 + i] = z
        s[1500 + i, i] = np.int8(-int(z[i]) // 2)
    s[[2500, 2999]] = np.clip(2 * z.astype(np.int16), -6, 6).astype(np.int8)
    s[3001:] = z
    return q, s
