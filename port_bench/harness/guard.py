"""The import guard: no module of JAX or of the JAX package may be loaded
in the process that prints a result. Names are compared by their top-level
part, whole, so the port (``fastdem_tpu_torch``) passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fastdem_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
