"""The harness's parts found by name: `load(kind, name)` is the module
`benchmark/<kind>/<name>.py`, loaded once.

- `inputs/<kind>.py`: a traffic file's `inputs` (`make`, `expected`,
  `small`; see `gen.py`);
- `entries/<entry>.py`: a traffic file's `entry`, an `Entry` class (see
  `entry.py`);
- `references/<mode>.py`: a configuration's `mode`, its plain reference
  (`make`; see `reference.py`);
- `hashes/<hasher>.py`: a configuration's `hasher`, the plain k-mer hash;
- `metrics/<metric>.py`: a metric's reader (`read(obs)`).

A new cell, mix, entry, mode or metric is new files and entries of
BENCHMARK.json only: nothing that exists is edited.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
_loaded = {}


def load(kind: str, name: str):
    """The module `benchmark/<kind>/<name>.py`."""
    key = (kind, name)
    if key not in _loaded:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            known = sorted(p.stem for p in (HERE / kind).glob("*.py"))
            raise ValueError(f"no {kind} named {name!r}: one of {known}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]
