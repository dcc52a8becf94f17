"""The IMDB schema and row counts (``imdb_schema.json``) and a
variable-length gather: what both the generator and the plain references
need, with nothing of the program."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "imdb_schema.json")) as _f:
    _SCHEMA = json.load(_f)

#: table -> [(column, type name)] of the 21 IMDB tables
ATTRIBUTES: Dict[str, List[Tuple[str, str]]] = {
    t: [(c, dt) for c, dt in cols] for t, cols in _SCHEMA["tables"].items()
}
#: real IMDB row counts (scale 1.0)
REAL_ROWS: Dict[str, int] = _SCHEMA["rows"]


def gather_varlen(heap: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """Variable-length gather: (new_heap, new_ends)."""
    lengths = lengths.astype(np.int64, copy=False)
    new_ends = np.cumsum(lengths)
    total = int(new_ends[-1]) if len(new_ends) else 0
    if total == 0:
        return np.zeros(0, dtype=np.uint8), new_ends
    out_starts = new_ends - lengths
    nz = lengths > 0
    src = (np.repeat(starts[nz].astype(np.int64) - out_starts[nz], lengths[nz])
           + np.arange(total, dtype=np.int64))
    return heap[src], new_ends
