"""Finds a configuration's architecture plug-in by name.

A configuration file names its architecture by the optional key
`architecture`; without it the architecture is `yoloclip`. The plug-in is
the module `perfbench/architectures/<name>.py` (see that package's
docstring for what it exposes), so a configuration of a new architecture
lands as new files only.
"""

from __future__ import annotations

import importlib
import os
import pkgutil
import sys
from types import ModuleType
from typing import Dict, List

DEFAULT = 'yoloclip'
PACKAGE = 'perfbench.architectures'
HERE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'architectures')


def available() -> List[str]:
    """The plug-ins under `perfbench/architectures/`."""
    return sorted(m.name for m in pkgutil.iter_modules([HERE]))


def load(cfg: Dict) -> ModuleType:
    """The plug-in module that `cfg['architecture']` names."""
    name = cfg.get('architecture', DEFAULT)
    full = f'{PACKAGE}.{name}'
    if full not in sys.modules and name not in available():
        raise ValueError(f'unknown architecture {name!r}; '
                         f'perfbench/architectures/ has {available()}')
    return importlib.import_module(full)
