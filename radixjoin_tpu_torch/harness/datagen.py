"""Synthetic IMDB generator (port of the query-free path of
radixjoin_tpu/harness/datagen.py).

The real IMDB dump is not redistributable with this repo, so the harness
generates a schema-conformant synthetic IMDB at a configurable scale.
Foreign keys follow the IMDB schema (movie_id -> title, person_id -> name,
...) with a skewed hot-key component and a correlated hot-entity region,
so the join-size distribution resembles the real workload.

This port carries the ``SyntheticIMDB(queries=None)`` path only: with no
queries there are no harvested literals, so literal mixing, witness
planting and the disk cache of the JAX package's generator do not apply.
For the same ``(scale, seed)`` it produces the same tables, column for
column, as the JAX package's generator does without queries.
"""

from __future__ import annotations

import string
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..dtypes import DataType
from ..sql import catalog
from ..storage.columnar import HostColumn, HostTable

# Approximate real IMDB row counts (sets *relative* table sizes).
REAL_ROWS: Dict[str, int] = {
    "aka_name": 901_343,
    "aka_title": 361_472,
    "cast_info": 36_244_344,
    "char_name": 3_140_339,
    "comp_cast_type": 4,
    "company_name": 234_997,
    "company_type": 4,
    "complete_cast": 135_086,
    "info_type": 113,
    "keyword": 134_170,
    "kind_type": 7,
    "link_type": 18,
    "movie_companies": 2_609_129,
    "movie_info": 14_835_720,
    "movie_info_idx": 1_380_035,
    "movie_keyword": 4_523_930,
    "movie_link": 29_997,
    "name": 4_167_491,
    "role_type": 12,
    "title": 2_528_312,
    "person_info": 2_963_664,
}

# column -> referenced table (foreign keys per job/schema.sql + fkindexes.sql)
FOREIGN_KEYS: Dict[str, Dict[str, str]] = {
    "aka_name": {"person_id": "name"},
    "aka_title": {"movie_id": "title", "kind_id": "kind_type", "episode_of_id": "title"},
    "cast_info": {
        "person_id": "name",
        "movie_id": "title",
        "person_role_id": "char_name",
        "role_id": "role_type",
    },
    "complete_cast": {
        "movie_id": "title",
        "subject_id": "comp_cast_type",
        "status_id": "comp_cast_type",
    },
    "movie_companies": {
        "movie_id": "title",
        "company_id": "company_name",
        "company_type_id": "company_type",
    },
    "movie_info": {"movie_id": "title", "info_type_id": "info_type"},
    "movie_info_idx": {"movie_id": "title", "info_type_id": "info_type"},
    "movie_keyword": {"movie_id": "title", "keyword_id": "keyword"},
    "movie_link": {
        "movie_id": "title",
        "linked_movie_id": "title",
        "link_type_id": "link_type",
    },
    "person_info": {"person_id": "name", "info_type_id": "info_type"},
    "title": {"kind_id": "kind_type", "episode_of_id": "title"},
}

# NULL fraction per (table, column); default by column kind below.
_NULL_FRACTION_OVERRIDES = {
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

# Enum-like tables: their value column holds ``<column>_<row>`` names.
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


class SyntheticIMDB:
    def __init__(
        self,
        scale: float = 0.001,
        seed: int = 0,
        min_rows: int = 50,
        hot_keys: int = 16,
        hot_fraction: float = 0.2,
    ):
        self.scale = scale
        self.seed = seed
        self.min_rows = min_rows
        self.hot_keys = hot_keys
        self.hot_fraction = hot_fraction

    # -- sizing ------------------------------------------------------------

    def table_rows(self, table: str) -> int:
        real = REAL_ROWS[table]
        if table in _ENUM_TABLES:
            return real
        return max(self.min_rows, int(real * self.scale))

    # -- per-column generators ----------------------------------------------

    def _null_fraction(self, table: str, column: str) -> float:
        if column in _NOT_NULL:
            return 0.0
        override = _NULL_FRACTION_OVERRIDES.get((table, column))
        if override is not None:
            return override
        return 0.3

    def _hot_region(self, table: str) -> int:
        """Ids ``1..hot`` of ``table`` form its correlated hot-entity
        region (see :meth:`generate_table`)."""
        n = self.table_rows(table)
        return max(min(n, 64), int(n * 0.04))

    def _gen_int(
        self, rng, table: str, column: str, n: int,
        hot: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        fk_target = FOREIGN_KEYS.get(table, {}).get(column)
        if column == "id":
            return np.arange(1, n + 1, dtype=np.int32)
        if fk_target is not None:
            target_n = self.table_rows(fk_target)
            uniform = rng.integers(1, target_n + 1, n)
            if target_n > self.hot_keys * 4 and self.hot_fraction > 0:
                hot_ids = rng.integers(1, target_n + 1, self.hot_keys)
                hot_pick = hot_ids[rng.integers(0, self.hot_keys, n)]
                use_hot = rng.random(n) < self.hot_fraction
                uniform = np.where(use_hot, hot_pick, uniform)
            if target_n > 256:
                # correlated hot-entity region: a slice of every FK column
                # points into the target's first ids, so rows of different
                # tables overlap on the same entities (real IMDB is
                # correlated this way). Fact tables put 10% of their mass
                # there, small link tables up to 60%.
                mass = max(0.10, min(0.6, 30_000 / REAL_ROWS[table]))
                hot_region = self._hot_region(fk_target)
                region_pick = rng.integers(1, hot_region + 1, n)
                use_region = rng.random(n) < mass
                uniform = np.where(use_region, region_pick, uniform)
            return uniform.astype(np.int32)
        if column == "production_year":
            vals = rng.integers(1880, 2026, n).astype(np.int32)
            if hot is not None:
                vals = np.where(
                    hot & (rng.random(n) < 0.8),
                    rng.integers(1990, 2016, n), vals
                ).astype(np.int32)
            return vals
        return rng.integers(0, 1000, n).astype(np.int32)

    def _gen_varchar_heap(self, rng, n: int, valid: np.ndarray,
                          min_len: int = 4, max_len: int = 18):
        """Random strings straight to (heap, ends), no per-row Python."""
        lens = rng.integers(min_len, max_len + 1, n).astype(np.int64)
        lens = np.where(valid, lens, 0)
        ends = np.cumsum(lens)
        total = int(ends[-1]) if n else 0
        heap = _RAND_CHARS[rng.integers(0, len(_RAND_CHARS), total)]
        return heap, ends

    # -- tables ---------------------------------------------------------------

    def _column_rng(self, table: str, column: str) -> np.random.Generator:
        """Independent deterministic substream per (table, column) — the
        hotness pass below reads FK columns out of catalog order, so
        column draws must not share one sequential stream."""
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, zlib.crc32(table.encode()),
             zlib.crc32(column.encode())]
        ))

    def _row_hotness(self, table: str, n: int) -> Optional[np.ndarray]:
        """Boolean hot-entity mask per row: link-table rows are hot when
        their main FK points into the target's hot-id region; entity
        tables are hot on their own first ids. Hot rows keep more of
        their validity, so NULLs do not sever the correlated region."""
        fks = FOREIGN_KEYS.get(table, {})
        for col, target in (("movie_id", "title"), ("person_id", "name")):
            if fks.get(col) == target:
                vals = self._gen_int(
                    self._column_rng(table, col), table, col, n
                )
                return vals <= self._hot_region(target)
        if table in _ENUM_TABLES:
            return None
        return np.arange(1, n + 1) <= self._hot_region(table)

    def generate_table(self, table: str) -> HostTable:
        n = self.table_rows(table)
        hot = self._row_hotness(table, n)
        columns = []
        for column, dtype in catalog.ATTRIBUTES[table]:
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
                    values = np.empty(n, dtype=object)
                    values[:] = [f"{column}_{i}".encode("latin-1")
                                 for i in range(n)]
                    values[~valid] = b""
                    columns.append(HostColumn(dtype, values, valid))
                else:
                    heap, ends = self._gen_varchar_heap(rng, n, valid)
                    columns.append(HostColumn.varchar(heap, ends, valid))
            else:
                values = self._gen_int(rng, table, column, n, hot=hot)
                values = values.copy()
                values[~valid] = 0
                columns.append(HostColumn(dtype, values, valid))
        return HostTable(n, columns)

    def generate(self, tables: Optional[List[str]] = None) -> Dict[str, HostTable]:
        names = tables if tables is not None else sorted(catalog.ATTRIBUTES)
        return {t: self.generate_table(t) for t in names}
