"""Kernel names to families, from the data files of ``benchmark/kernels/``.

A frozen copy of the program's ``tools/trace_table.py`` ``category`` with
its name patterns moved into one JSON file a family
(``kernels/<family>.json``: ``order``, ``patterns``, and for the program's
own kernels ``pieces``, the prefixes of the ``counts/roofline.py``
``kernel_pieces`` it does). A kernel takes the family of lowest ``order``
one of whose patterns is in its lower-cased name; none gives ``other``.
A later kernel under a new name is one more file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"


def families(directory: Path = KERNELS_DIR) -> List[Dict]:
    """Every family file, in ``order``."""
    out = []
    for path in sorted(directory.glob("*.json")):
        with open(path) as f:
            fam = json.load(f)
        fam["name"] = path.stem
        out.append(fam)
    return sorted(out, key=lambda f: (f["order"], f["name"]))


def category(name: str, fams: List[Dict]) -> str:
    low = name.lower()
    for fam in fams:
        if any(p in low for p in fam["patterns"]):
            return fam["name"]
    return "other"


def by_family(kernels: Iterable[Tuple[str, float]], fams: List[Dict]) -> Dict[str, float]:
    """Sum of ``(name, seconds)`` by family, every family present."""
    out = {f["name"]: 0.0 for f in fams}
    out["other"] = 0.0
    for name, s in kernels:
        out[category(name, fams)] += s
    return out
