"""The hand kernels' wrappers, and the registry of their launch counters.

Each wrapper module counts its kernel's launches in module-level integers,
incremented only where it launches, under a lock of its own, and
registers them here at import. Code that must adjust the counts without
knowing the kernels (a replayed program, `inference/program.py`) reads
and adds them through `read_counts` and `add_counts`.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Sequence, Tuple

# module name -> (its counters' lock, its counter names)
_COUNTERS: Dict[str, Tuple[threading.Lock, Tuple[str, ...]]] = {}


def register_counters(module: str, lock: threading.Lock,
                      names: Sequence[str]) -> None:
    """Register the module-level launch counters `names` of the module
    named `module`, guarded by `lock`."""
    _COUNTERS[module] = (lock, tuple(names))


def read_counts() -> Dict[str, int]:
    """{'module.counter': count} of every registered counter."""
    out = {}
    for mod, (lock, names) in list(_COUNTERS.items()):
        m = sys.modules[mod]
        with lock:
            out.update((f'{mod}.{n}', getattr(m, n)) for n in names)
    return out


def add_counts(delta: Dict[str, int]) -> None:
    """Add {'module.counter': n} (n may be negative) to the counters."""
    for key, n in delta.items():
        mod, name = key.rsplit('.', 1)
        lock, _ = _COUNTERS[mod]
        m = sys.modules[mod]
        with lock:
            setattr(m, name, getattr(m, name) + n)
