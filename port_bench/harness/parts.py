"""The benchmark's parts found by name: the file ``<kind>/<name>.py`` under
its folder (a metric's reader, a loop, a sensor's generator)."""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@functools.lru_cache(maxsize=None)
def part(kind: str, name: str):
    """The module of ``<kind>/<name>.py``, loaded once."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} {name!r}: {kind}/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
