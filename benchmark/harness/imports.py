"""The run's import check: nothing it loads may be JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word, so the port, ``fandom_search_tpu_torch``,
is not taken for the JAX package ``fandom_search_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fandom_search_tpu"})


class ForbiddenImport(RuntimeError):
    pass


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def forbidden_modules(raise_if_any: bool = False) -> List[str]:
    """Forbidden top-level names now in ``sys.modules``."""
    found = forbidden(list(sys.modules))
    if found and raise_if_any:
        raise ForbiddenImport(f"loaded in this process: {', '.join(found)}")
    return found
