"""The benchmark's synthetic IMDB: a copy of the port's generator
(``radixjoin_tpu_torch/harness/datagen.py``, numpy only) that reads the
query literals it mixes into the columns from data instead of parsing SQL,
so a change to the port's SQL front end cannot move the data.

Each (table, column) draws from its own seeded substream, so a table is the
same whichever other tables are generated and in whatever order. Foreign
keys follow the IMDB schema with a skewed hot-key component and a
correlated hot-entity region (the first 4% of a target's ids), as in the
original. Left out of the copy: the witness rows it plants for query
documents (they need the SQL parser; at scale 1.0 every document of this
benchmark returns thousands of rows without them) and its disk cache.
"""

from __future__ import annotations

import concurrent.futures
import json
import string
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from radixjoin_tpu_torch import DataType
from radixjoin_tpu_torch.storage.columnar import HostColumn, HostTable

from . import schema

#: table -> [(column, DataType)] of the 21 IMDB tables
ATTRIBUTES: Dict[str, List[Tuple[str, DataType]]] = {
    t: [(c, DataType[dt]) for c, dt in cols]
    for t, cols in schema.ATTRIBUTES.items()
}
REAL_ROWS = schema.REAL_ROWS
gather_varlen = schema.gather_varlen

FOREIGN_KEYS: Dict[str, Dict[str, str]] = {
    "aka_name": {"person_id": "name"},
    "aka_title": {"movie_id": "title", "kind_id": "kind_type",
                  "episode_of_id": "title"},
    "cast_info": {"person_id": "name", "movie_id": "title",
                  "person_role_id": "char_name", "role_id": "role_type"},
    "complete_cast": {"movie_id": "title", "subject_id": "comp_cast_type",
                      "status_id": "comp_cast_type"},
    "movie_companies": {"movie_id": "title", "company_id": "company_name",
                        "company_type_id": "company_type"},
    "movie_info": {"movie_id": "title", "info_type_id": "info_type"},
    "movie_info_idx": {"movie_id": "title", "info_type_id": "info_type"},
    "movie_keyword": {"movie_id": "title", "keyword_id": "keyword"},
    "movie_link": {"movie_id": "title", "linked_movie_id": "title",
                   "link_type_id": "link_type"},
    "person_info": {"person_id": "name", "info_type_id": "info_type"},
    "title": {"kind_id": "kind_type", "episode_of_id": "title"},
}

_NULL_FRACTION_OVERRIDES: Dict[Tuple[str, str], float] = {
    ("cast_info", "person_role_id"): 0.3,
    ("cast_info", "note"): 0.5,
    ("cast_info", "nr_order"): 0.5,
    ("title", "episode_of_id"): 0.9,
    ("title", "production_year"): 0.05,
    ("aka_title", "episode_of_id"): 0.95,
    ("movie_companies", "note"): 0.5,
    ("movie_info", "note"): 0.7,
    ("movie_info_idx", "note"): 0.9,
    ("person_info", "note"): 0.8,
}

_NOT_NULL = {"id", "movie_id", "person_id", "company_id", "company_type_id",
             "info_type_id", "keyword_id", "link_type_id", "role_id",
             "kind_id", "subject_id", "status_id", "linked_movie_id",
             "name", "title", "keyword", "kind", "info", "link", "role"}

_ENUM_TABLES = {
    "comp_cast_type": "kind",
    "company_type": "kind",
    "info_type": "info",
    "kind_type": "kind",
    "link_type": "link",
    "role_type": "role",
}

_RAND_CHARS = np.frombuffer(
    (string.ascii_letters + string.digits + " ()[]-.:,'&").encode("latin-1"),
    dtype=np.uint8,
)

#: known real-IMDB match fractions of the filter columns JOB leans on
#: hardest: (table, column) -> (equality fraction, LIKE base rate)
REAL_SELECTIVITY: Dict[Tuple[str, str], Tuple[float, Optional[float]]] = {
    ("name", "gender"): (0.30, None),
    ("cast_info", "note"): (0.02, 0.01),
}


class Literals:
    """Literals the queries compare against, per (table, column): equality
    strings, LIKE patterns and numbers, in the order the queries state them
    (repeats kept). Read from a JSON file of the form
    ``{"eq": [[table, column, [str, ...]], ...], "like": [...],
    "numeric": [...]}``, strings as latin-1."""

    def __init__(self, eq=None, like=None, numeric=None):
        self.eq: Dict[Tuple[str, str], List[bytes]] = eq or {}
        self.like: Dict[Tuple[str, str], List[bytes]] = like or {}
        self.numeric: Dict[Tuple[str, str], List[float]] = numeric or {}

    @staticmethod
    def load(path: str) -> "Literals":
        with open(path) as f:
            doc = json.load(f)

        def strings(kind):
            return {(t, c): [v.encode("latin-1") for v in vals]
                    for t, c, vals in doc.get(kind, [])}

        return Literals(strings("eq"), strings("like"),
                        {(t, c): list(vals)
                         for t, c, vals in doc.get("numeric", [])})


def _instantiate_like(rng: np.random.Generator, pattern: bytes) -> bytes:
    """A string matching a LIKE pattern (% -> random run, _ -> one char)."""
    out = bytearray()
    for ch in pattern:
        c = bytes([ch])
        if c == b"%":
            n = int(rng.integers(0, 7))
            out += bytes(_RAND_CHARS[rng.integers(0, len(_RAND_CHARS), n)])
        elif c == b"_":
            out += bytes(_RAND_CHARS[rng.integers(0, len(_RAND_CHARS), 1)])
        else:
            out.append(ch)
    return bytes(out)


def _pool_heap(pool: List[bytes]):
    lengths = np.fromiter((len(p) for p in pool), np.int64, len(pool))
    ends = np.cumsum(lengths)
    heap = (np.frombuffer(b"".join(pool), dtype=np.uint8).copy()
            if pool else np.zeros(0, np.uint8))
    return heap, ends - lengths, lengths


class SyntheticIMDB:
    """The synthetic IMDB at ``scale`` (1.0: the real dump's row counts)
    from ``seed``, with ``literals`` mixed into the filtered columns."""

    def __init__(self, scale: float = 1.0, seed: int = 0,
                 literals: Optional[Literals] = None, min_rows: int = 50,
                 hot_keys: int = 16, hot_fraction: float = 0.2):
        self.scale = scale
        self.seed = seed
        self.min_rows = min_rows
        self.hot_keys = hot_keys
        self.hot_fraction = hot_fraction
        self.harvest = literals or Literals()

    def table_rows(self, table: str) -> int:
        real = REAL_ROWS[table]
        if table in _ENUM_TABLES:
            pool = self.harvest.eq.get((table, _ENUM_TABLES[table]), [])
            return max(real, len(set(pool)))
        return max(self.min_rows, int(real * self.scale))

    def _null_fraction(self, table: str, column: str) -> float:
        if column in _NOT_NULL:
            return 0.0
        override = _NULL_FRACTION_OVERRIDES.get((table, column))
        return 0.3 if override is None else override

    def _hot_region(self, table: str) -> int:
        n = self.table_rows(table)
        return max(min(n, 64), int(n * 0.04))

    def _gen_int(self, rng, table: str, column: str, n: int,
                 hot: Optional[np.ndarray] = None) -> np.ndarray:
        key = (table, column)
        fk_target = FOREIGN_KEYS.get(table, {}).get(column)
        if column == "id":
            return np.arange(1, n + 1, dtype=np.int32)
        if fk_target is not None:
            target_n = self.table_rows(fk_target)
            uniform = rng.integers(1, target_n + 1, n)
            if fk_target in _ENUM_TABLES and hot is not None:
                # hot rows lean toward the enum ids the queries name
                pool_n = len(dict.fromkeys(self.harvest.eq.get(
                    (fk_target, _ENUM_TABLES[fk_target]), [])))
                if pool_n:
                    enum_pick = rng.integers(1, pool_n + 1, n)
                    use_enum = rng.random(n) < 0.5
                    uniform = np.where(hot & use_enum, enum_pick, uniform)
            if target_n > self.hot_keys * 4 and self.hot_fraction > 0:
                hot_ids = rng.integers(1, target_n + 1, self.hot_keys)
                hot_pick = hot_ids[rng.integers(0, self.hot_keys, n)]
                use_hot = rng.random(n) < self.hot_fraction
                uniform = np.where(use_hot, hot_pick, uniform)
            if target_n > 256:
                # the correlated hot-entity region: 10% of a fact table's
                # keys (up to 60% of a small link table's) point into the
                # target's first 4% of ids
                mass = max(0.10, min(0.6, 30_000 / REAL_ROWS[table]))
                hot_region = self._hot_region(fk_target)
                region_pick = rng.integers(1, hot_region + 1, n)
                use_region = rng.random(n) < mass
                uniform = np.where(use_region, region_pick, uniform)
            return uniform.astype(np.int32)
        lits = self.harvest.numeric.get(key)
        if lits:
            lo, hi = min(lits), max(lits)
            span = max(hi - lo, 1)
            vals = rng.integers(int(lo - span), int(hi + span) + 1,
                                n).astype(np.int32)
            if hot is not None and hi > lo:
                in_range = rng.integers(int(lo), int(hi) + 1, n)
                vals = np.where(hot & (rng.random(n) < 0.8), in_range,
                                vals).astype(np.int32)
            return vals
        if column == "production_year":
            vals = rng.integers(1880, 2026, n).astype(np.int32)
            if hot is not None:
                vals = np.where(hot & (rng.random(n) < 0.8),
                                rng.integers(1990, 2016, n),
                                vals).astype(np.int32)
            return vals
        return rng.integers(0, 1000, n).astype(np.int32)

    def _gen_varchar_heap(self, rng, table: str, column: str, n: int,
                          valid: np.ndarray, min_len: int = 4,
                          max_len: int = 18,
                          hot: Optional[np.ndarray] = None):
        """Random strings mixed with the literals (rate capped at 45%, 90%
        on hot rows), straight to (heap, ends)."""
        key = (table, column)
        eqs = [e for e in dict.fromkeys(self.harvest.eq.get(key, [])) if e]
        patterns = list(dict.fromkeys(self.harvest.like.get(key, [])))
        singles = []
        for p in patterns:
            for s in (_instantiate_like(rng, p) for _ in range(3)):
                if s:
                    singles.append((s, p))
        pairs: List[bytes] = []
        for i, p in enumerate(patterns[:12]):
            for q in patterns[i + 1:12]:
                pairs.append(_instantiate_like(rng, p)
                             + _instantiate_like(rng, q))
                pairs.append(_instantiate_like(rng, q)
                             + _instantiate_like(rng, p))
        pool: List[bytes] = eqs + [s for s, _p in singles] + pairs
        eq_p, like_base = REAL_SELECTIVITY.get(key, (0.005, None))

        def _like_p(pattern: bytes) -> float:
            body = len(pattern.replace(b"%", b"").replace(b"_", b""))
            base = like_base if like_base is not None else 0.08
            return float(np.clip(base * 0.45 ** max(0, body - 2),
                                 0.0005, 0.06))

        frac = np.concatenate([
            np.full(len(eqs), eq_p),
            np.array([_like_p(p) for _s, p in singles])
            if singles else np.zeros(0),
            np.full(len(pairs), 0.0008),
        ]) if pool else np.zeros(0)
        cold_rate = min(float(frac.sum()), 0.45)

        lens = rng.integers(min_len, max_len + 1, n).astype(np.int64)
        picks = use_pool = None
        if pool:
            pheap, pstarts, plens = _pool_heap(pool)
            rate = np.where(hot, 0.9, cold_rate) if hot is not None else cold_rate
            use_pool = rng.random(n) < rate
            picks = rng.choice(len(pool), n, p=frac / frac.sum())
            lens = np.where(use_pool, plens[picks], lens)
        lens = np.where(valid, lens, 0)

        rand_sel = valid if use_pool is None else (valid & ~use_pool)
        rand_lens = np.where(rand_sel, lens, 0)
        rand_ends = np.cumsum(rand_lens)
        rand_total = int(rand_ends[-1]) if n else 0
        rand_heap = _RAND_CHARS[rng.integers(0, len(_RAND_CHARS), rand_total)]
        if use_pool is None:
            return rand_heap, rand_ends
        combined = np.concatenate([rand_heap, pheap])
        starts = np.where(valid & use_pool, rand_total + pstarts[picks],
                          rand_ends - rand_lens)
        return gather_varlen(combined, starts, lens)

    def _column_rng(self, table: str, column: str) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, zlib.crc32(table.encode()),
             zlib.crc32(column.encode())]))

    def _row_hotness(self, table: str, n: int) -> Optional[np.ndarray]:
        """Rows of a link table whose main foreign key lands in the
        target's hot region; an entity table's own first ids."""
        fks = FOREIGN_KEYS.get(table, {})
        for col, target in (("movie_id", "title"), ("person_id", "name")):
            if fks.get(col) == target:
                vals = self._gen_int(self._column_rng(table, col), table,
                                     col, n)
                return vals <= self._hot_region(target)
        if table in _ENUM_TABLES:
            return None
        return np.arange(1, n + 1) <= self._hot_region(table)

    def _column(self, table: str, column: str, dtype: DataType, n: int,
                hot) -> HostColumn:
        rng = self._column_rng(table, column)
        nf = self._null_fraction(table, column)
        if nf > 0:
            r = rng.random(n)
            valid = r >= nf
            if hot is not None:
                valid = np.where(hot, r >= nf * 0.2, valid)
        else:
            valid = np.ones(n, dtype=bool)
        if dtype is DataType.VARCHAR:
            if table in _ENUM_TABLES and column == _ENUM_TABLES[table]:
                values = self._enum_values(table, column, n).copy()
                values[~valid] = b""
                return HostColumn(dtype, values, valid)
            heap, ends = self._gen_varchar_heap(rng, table, column, n, valid,
                                                hot=hot)
            return HostColumn.varchar(heap, ends, valid)
        values = self._gen_int(rng, table, column, n, hot=hot).copy()
        values[~valid] = 0
        return HostColumn(dtype, values, valid)

    def _enum_values(self, table: str, column: str, n: int) -> np.ndarray:
        pool = [e for e in dict.fromkeys(self.harvest.eq.get((table, column),
                                                             [])) if e]
        rng = self._column_rng(table, f"{column}/like")
        for pattern in dict.fromkeys(self.harvest.like.get((table, column),
                                                           [])):
            pool.extend(_instantiate_like(rng, pattern) for _ in range(2))
        pool = list(dict.fromkeys(pool))
        values = np.empty(n, dtype=object)
        for i in range(n):
            values[i] = (pool[i] if i < len(pool)
                         else f"{column}_{i}".encode("latin-1"))
        return values

    def generate(self, tables: List[str],
                 threads: int = 8) -> Dict[str, HostTable]:
        """The named tables, their columns generated on ``threads`` threads
        (numpy releases the interpreter lock in the bulk calls)."""
        rows = {t: self.table_rows(t) for t in tables}
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            hot = dict(zip(tables, pool.map(
                lambda t: self._row_hotness(t, rows[t]), tables)))
            jobs = [(t, c, dt) for t in tables for c, dt in ATTRIBUTES[t]]
            cols = list(pool.map(
                lambda j: self._column(j[0], j[1], j[2], rows[j[0]],
                                       hot[j[0]]), jobs))
        out: Dict[str, List[HostColumn]] = {t: [] for t in tables}
        for (t, _c, _dt), col in zip(jobs, cols):
            out[t].append(col)
        return {t: HostTable(rows[t], out[t]) for t in tables}
