"""Synthetic IMDB generator, literal-aware (own copy of
radixjoin_tpu/harness/datagen.py: numpy and the standard library only).

The real 1.2 GB IMDB CSV dump is not redistributable with this repo, so the
correctness/benchmark harness generates a schema-conformant synthetic IMDB
at a configurable scale. To keep the 113 JOB queries *meaningful* (filters
must select non-trivial fractions; joins must produce rows), the generator
harvests every literal the queries compare against — equality strings, LIKE
patterns, numeric ranges — and mixes harvested values (and strings
instantiated from LIKE patterns) into the generated columns.

Foreign keys follow the IMDB schema (movie_id -> title, person_id -> name,
...) with a skewed hot-key component, so the join-size distribution
resembles the real workload (and exercises the skew handling of the
distributed path).

Deterministic for a given (scale, seed, queries): column for column the
tables of the JAX package's generator, with and without queries.
"""

from __future__ import annotations

import string
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import DataType
from ..sql import catalog
from ..sql.frontend import ParsedSQL
from ..sql.predicate import Comparison, LogicalOperation, Op, Statement
from ..storage.columnar import HostColumn, HostTable, gather_varlen

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

# Enum-like tables whose values come first from harvested literals.
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

#: Known real-IMDB per-literal match fractions for the filter columns
#: JOB leans on hardest: (table, column) -> (eq_p, like_base). Public
#: frequency facts (like REAL_ROWS / job/schema.sql), not tuned numbers:
#: name.gender has ~3 values ('f' alone is ~1/3 of non-null rows — the
#: v7 default of 0.5% starved every 9-family intermediate), and
#: cast_info.note values like '(voice)' each cover a few percent of the
#: 36M-row table. Columns not listed use the defaults in
#: ``_gen_varchar_heap`` (eq 0.5%, length-decaying LIKE).
REAL_SELECTIVITY: Dict[Tuple[str, str], Tuple[float, Optional[float]]] = {
    ("name", "gender"): (0.30, None),
    ("cast_info", "note"): (0.02, 0.01),
}


class LiteralHarvest:
    """Literals the JOB queries compare against, per (table, column)."""

    def __init__(self):
        self.eq: Dict[Tuple[str, str], List] = {}
        self.like: Dict[Tuple[str, str], List[bytes]] = {}
        self.numeric: Dict[Tuple[str, str], List[float]] = {}

    def scan_queries(self, queries: List[str]) -> "LiteralHarvest":
        return self.scan_parsed([ParsedSQL(sql) for sql in queries])

    def scan_parsed(self, parsed: List[ParsedSQL]) -> "LiteralHarvest":
        for p in parsed:
            for entity, stmt in p.filters.items():
                self._walk(entity.table, stmt)
        return self

    def _walk(self, table: str, stmt: Statement) -> None:
        if isinstance(stmt, LogicalOperation):
            for child in stmt.children:
                self._walk(table, child)
            return
        assert isinstance(stmt, Comparison)
        column = catalog.ATTRIBUTES[table][stmt.column][0]
        key = (table, column)
        if stmt.op in (Op.IS_NULL, Op.IS_NOT_NULL):
            return
        if stmt.op in (Op.LIKE, Op.NOT_LIKE):
            self.like.setdefault(key, []).append(stmt.value)
        elif isinstance(stmt.value, bytes):
            self.eq.setdefault(key, []).append(stmt.value)
        else:
            self.numeric.setdefault(key, []).append(stmt.value)


def _instantiate_like(rng: np.random.Generator, pattern: bytes) -> bytes:
    """Produce a string matching a LIKE pattern (%% -> junk, _ -> char)."""
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


def _random_strings(rng: np.random.Generator, n: int, min_len=4, max_len=18):
    lens = rng.integers(min_len, max_len + 1, n)
    total = int(lens.sum())
    flat = _RAND_CHARS[rng.integers(0, len(_RAND_CHARS), total)]
    out = np.empty(n, dtype=object)
    pos = 0
    buf = flat.tobytes()
    for i in range(n):
        l = int(lens[i])
        out[i] = buf[pos : pos + l]
        pos += l
    return out


def _pool_heap(pool: List[bytes]):
    """(heap, starts, lengths) of a literal pool."""
    lengths = np.fromiter((len(p) for p in pool), np.int64, len(pool))
    ends = np.cumsum(lengths)
    heap = (
        np.frombuffer(b"".join(pool), dtype=np.uint8).copy()
        if pool else np.zeros(0, np.uint8)
    )
    return heap, ends - lengths, lengths


class SyntheticIMDB:
    def __init__(
        self,
        scale: float = 0.001,
        seed: int = 0,
        queries: Optional[List[str]] = None,
        min_rows: int = 50,
        hot_keys: int = 16,
        hot_fraction: float = 0.2,
        witnesses: int = 4,
    ):
        self.scale = scale
        self.seed = seed
        self.min_rows = min_rows
        self.hot_keys = hot_keys
        self.hot_fraction = hot_fraction
        self.witnesses = witnesses
        self.harvest = LiteralHarvest()
        self.parsed_queries: List[ParsedSQL] = []
        if queries:
            self.parsed_queries = [ParsedSQL(q) for q in queries]
            self.harvest.scan_parsed(self.parsed_queries)

    # -- sizing ------------------------------------------------------------

    def table_rows(self, table: str) -> int:
        real = REAL_ROWS[table]
        if table in _ENUM_TABLES:
            pool = self.harvest.eq.get((table, _ENUM_TABLES[table]), [])
            return max(real, len(set(pool)))
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
        key = (table, column)
        fk_target = FOREIGN_KEYS.get(table, {}).get(column)
        if column == "id":
            return np.arange(1, n + 1, dtype=np.int32)
        if fk_target is not None:
            target_n = self.table_rows(fk_target)
            uniform = rng.integers(1, target_n + 1, n)
            if fk_target in _ENUM_TABLES and hot is not None:
                # hot rows bias enum FKs toward the query-referenced enum
                # ids (harvested literals occupy ids 1..pool_n, see
                # _enum_values) — in real IMDB hot movies HAVE a
                # 'rating' movie_info_idx row, a 'movie' kind, etc.;
                # without this the enum-id equality conjuncts
                # decorrelate the hot region (26a/26b collapse)
                pool_n = len(dict.fromkeys(self.harvest.eq.get(
                    (fk_target, _ENUM_TABLES[fk_target]), []
                )))
                if pool_n:
                    enum_pick = rng.integers(1, pool_n + 1, n)
                    use_enum = rng.random(n) < 0.5
                    uniform = np.where(
                        hot & use_enum, enum_pick, uniform
                    )
            if target_n > self.hot_keys * 4 and self.hot_fraction > 0:
                hot_ids = rng.integers(1, target_n + 1, self.hot_keys)
                hot_pick = hot_ids[rng.integers(0, self.hot_keys, n)]
                use_hot = rng.random(n) < self.hot_fraction
                uniform = np.where(use_hot, hot_pick, uniform)
            if target_n > 256:
                # correlated hot-entity region: a slice of every FK
                # column points into the target's first ids, so
                # filter-survivor sets of different tables overlap on
                # the same entities (real IMDB is correlated this way —
                # famous movies/people are dense in every link table;
                # independent sampling makes multi-filter joins
                # vanish)
                # hot-region mass on a 4% region. Fact tables get 10%
                # (2.5x enrichment — more measured an 84M-row blowup for
                # 18c at scale 0.1 via hot x hot fan-out); small link
                # tables (movie_link: 30k rows real) get up to 60% —
                # in real IMDB those tables cover almost exclusively
                # famous entities, and without that mass any query
                # chaining through them starves (7b/21a)
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
            vals = rng.integers(
                int(lo - span), int(hi + span) + 1, n
            ).astype(np.int32)
            if hot is not None and hi > lo:
                # hot rows: concentrate in the harvested literal range
                in_range = rng.integers(int(lo), int(hi) + 1, n)
                vals = np.where(
                    hot & (rng.random(n) < 0.8), in_range, vals
                ).astype(np.int32)
            return vals
        if column == "production_year":
            vals = rng.integers(1880, 2026, n).astype(np.int32)
            if hot is not None:
                vals = np.where(
                    hot & (rng.random(n) < 0.8),
                    rng.integers(1990, 2016, n), vals
                ).astype(np.int32)
            return vals
        return rng.integers(0, 1000, n).astype(np.int32)

    def _gen_varchar_heap(
        self, rng, table: str, column: str, n: int, valid: np.ndarray,
        min_len: int = 4, max_len: int = 18,
        hot: Optional[np.ndarray] = None,
    ):
        """Vectorized VARCHAR generation straight to (heap, ends).

        Random strings mixed with harvested literals (45% pool rate, 90%
        for hot-entity rows — see :meth:`generate_table`), all in flat
        byte-heap form — no per-row Python: at scale 1.0 this path runs
        over 36M-row columns on a single core."""
        key = (table, column)
        # never emit b'' as a value: the reference CSV dialect reads an
        # empty field as NULL (build_table.cpp empty -> monostate), so
        # empty strings cannot round-trip — and real IMDB has none
        # (13b/13c harvest b'' via ``t.title != ''``)
        eqs = [e for e in dict.fromkeys(self.harvest.eq.get(key, [])) if e]
        patterns = list(dict.fromkeys(self.harvest.like.get(key, [])))
        singles = []          # (instantiated string, source pattern)
        for p in patterns:
            for s in (_instantiate_like(rng, p) for _ in range(3)):
                if s:
                    singles.append((s, p))
        # pairwise combinations: queries AND several LIKEs on one column
        # (5a: note LIKE '%(theatrical)%' AND LIKE '%(France)%') — no
        # single-pattern instantiation can satisfy both, so emit
        # concatenations in both orders (covers anchored patterns)
        pairs: List[bytes] = []
        for i, p in enumerate(patterns[:12]):
            for q in patterns[i + 1:12]:
                pairs.append(_instantiate_like(rng, p)
                             + _instantiate_like(rng, q))
                pairs.append(_instantiate_like(rng, q)
                             + _instantiate_like(rng, p))
        pool: List[bytes] = eqs + [s for s, _p in singles] + pairs
        # Per-ITEM absolute match fractions (refined in v8 for the rank
        # outliers 3c/9c):
        #
        # * eq literals default to ~0.5% of non-hot rows, but columns in
        #   ``REAL_SELECTIVITY`` use known real-IMDB frequencies —
        #   name.gender='f' matches ~35% of real names, not 0.5% (v7
        #   starved the whole 9-family: 9b ranked 2/113 synthetic vs
        #   47/113 on reference runtimes);
        # * LIKE instantiation rates decay with pattern-body length — a
        #   2-char '%An%' matches far more real strings than a 6-char
        #   '%sequel%' (random-text containment shrinks ~geometrically
        #   with substring length);
        # * pairs stay rare (queries AND several LIKEs).
        #
        # The hot-entity boost stays FLAT 0.9: a v8 experiment made it
        # proportional to the cold rate (x20, cap 0.9) to damp the
        # 3-family's '%sequel%' over-match — and collapsed the entire
        # intermediate distribution (16b, the reference's heaviest
        # query, fell to 4.4k join rows; Spearman 0.687 -> 0.445),
        # because the 90% hot match rate is what makes the filter
        # survivors of DIFFERENT tables overlap on the same entities
        # (multi-filter joins die as rate^k otherwise). The 3-family
        # over-match is the accepted price of that structure; hot rows
        # pick pool items by the same per-item weights, so sparse
        # patterns at least get a minority share of the hot mass.
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
        weights = frac
        cold_rate = min(float(frac.sum()), 0.45)

        lens = rng.integers(min_len, max_len + 1, n).astype(np.int64)
        picks = use_pool = None
        if pool:
            pheap, pstarts, plens = _pool_heap(pool)
            rate = (np.where(hot, 0.9, cold_rate)
                    if hot is not None else cold_rate)
            use_pool = rng.random(n) < rate
            picks = rng.choice(
                len(pool), n, p=weights / weights.sum()
            )
            lens = np.where(use_pool, plens[picks], lens)
        lens = np.where(valid, lens, 0)

        # random source chars only for valid non-pool rows
        rand_sel = valid if use_pool is None else (valid & ~use_pool)
        rand_lens = np.where(rand_sel, lens, 0)
        rand_ends = np.cumsum(rand_lens)
        rand_total = int(rand_ends[-1]) if n else 0
        rand_heap = _RAND_CHARS[rng.integers(0, len(_RAND_CHARS), rand_total)]

        if use_pool is None:
            return rand_heap, rand_ends
        combined = np.concatenate([rand_heap, pheap])
        starts = np.where(
            valid & use_pool, rand_total + pstarts[picks],
            rand_ends - rand_lens,
        )
        heap, ends = gather_varlen(combined, starts, lens)
        return heap, ends

    # -- tables ---------------------------------------------------------------

    def _column_rng(self, table: str, column: str) -> np.random.Generator:
        """Independent deterministic substream per (table, column) — the
        hotness two-pass below reads FK columns out of catalog order, so
        column draws must not share one sequential stream."""
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, zlib.crc32(table.encode()),
             zlib.crc32(column.encode())]
        ))

    def _row_hotness(self, table: str, n: int) -> Optional[np.ndarray]:
        """Boolean hot-entity mask per row.

        Link-table rows are hot when their main FK points into the
        target's hot-id region; entity tables are hot on their own first
        ids. Filter-column generators boost literal hits and validity on
        hot rows, so the filter survivors of *different* tables overlap
        on the same entities and multi-filter join results stay
        non-empty (7b/26a/26b collapsed to zero rows
        under independent sampling)."""
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
                    # hot rows keep 80%+ validity so NULLs don't sever
                    # the correlated region (NULL keys never join)
                    valid = np.where(hot, r >= nf * 0.2, valid)
            else:
                valid = np.ones(n, dtype=bool)
            if dtype is DataType.VARCHAR:
                if table in _ENUM_TABLES and column == _ENUM_TABLES[table]:
                    values = self._enum_values(table, column, n).copy()
                    values[~valid] = b""
                    columns.append(HostColumn(dtype, values, valid))
                else:
                    heap, ends = self._gen_varchar_heap(
                        rng, table, column, n, valid, hot=hot
                    )
                    columns.append(HostColumn.varchar(heap, ends, valid))
            else:
                values = self._gen_int(rng, table, column, n, hot=hot)
                values = values.copy()
                values[~valid] = 0
                columns.append(HostColumn(dtype, values, valid))
        return HostTable(n, columns)

    def _enum_values(self, table: str, column: str, n: int) -> np.ndarray:
        pool = [e for e in dict.fromkeys(
            self.harvest.eq.get((table, column), [])
        ) if e]
        # enum columns are also LIKE-filtered (lt.link LIKE '%follow%',
        # cct.kind LIKE '%complete%'): instantiate those patterns too or
        # the filter selects nothing
        rng = self._column_rng(table, f"{column}/like")
        for pattern in dict.fromkeys(
            self.harvest.like.get((table, column), [])
        ):
            pool.extend(
                _instantiate_like(rng, pattern) for _ in range(2)
            )
        pool = list(dict.fromkeys(pool))
        values = np.empty(n, dtype=object)
        for i in range(n):
            if i < len(pool):
                values[i] = pool[i]
            else:
                values[i] = f"{column}_{i}".encode("latin-1")
        return values

    def generate(self, tables: Optional[List[str]] = None) -> Dict[str, HostTable]:
        names = tables if tables is not None else sorted(catalog.ATTRIBUTES)
        out = {t: self.generate_table(t) for t in names}
        if self.parsed_queries and self.witnesses > 0 and tables is None:
            _plant_witnesses(self, out)
        return out


# ---------------------------------------------------------------------------
# Witness planting: deterministic rows guaranteeing non-empty query results
# ---------------------------------------------------------------------------
#
# Probability tuning alone cannot make every 113-query conjunction survive
# at every scale (long FK chains through 30k-row tables times multi-LIKE
# filters multiply to ~0 under any reasonable distribution). The standard
# synthetic-benchmark fix is to PLANT WITNESSES: for each query, write a
# handful of rows per referenced entity that jointly satisfy the query's
# full filter + join pattern. The planted mass (113 queries x 4 witnesses
# x ~8 entities) is thousands of rows in a 74M-row database — it fixes
# non-emptiness without distorting the distributions the heavy joins run
# over. Results stay exact by construction (the oracle sees the same
# planted data).


def _synth_candidates(cmp, dtype) -> List:
    """Candidate values (or NULL) satisfying one comparison."""
    from ..sql.predicate import Op, like_match  # noqa: F401

    v = cmp.value
    op = cmp.op
    if op is Op.IS_NULL:
        return [NULL_SENTINEL]
    if op is Op.IS_NOT_NULL:
        return [b"witness" if dtype is DataType.VARCHAR else 1]
    if dtype is DataType.VARCHAR:
        if not isinstance(v, bytes):
            return []
        if op is Op.EQ:
            return [v]
        if op is Op.NEQ:
            return [v + b"x", b"w" + v]
        if op is Op.LIKE:
            rng = np.random.default_rng(zlib.crc32(v) & 0xFFFF)
            return [_instantiate_like(rng, v) for _ in range(4)]
        if op is Op.NOT_LIKE:
            return [b"zq9", b"witness"]
        if op in (Op.GT, Op.GEQ):
            return [v + b"z", v]
        if op in (Op.LT, Op.LEQ):
            # never emit b"": CSV ingest reads an empty field as NULL
            # (reference build_table.cpp empty -> monostate), which would
            # desync the CSV and in-memory paths
            return ([v[:-1]] if len(v) > 1 else []) + [v]
        return []
    # numeric
    if not isinstance(v, (int, float)):
        return []
    iv = int(v)
    if op is Op.EQ:
        return [iv]
    if op is Op.NEQ:
        return [iv + 1]
    if op is Op.GT:
        return [iv + 1, iv + 2]
    if op is Op.GEQ:
        return [iv, iv + 1]
    if op is Op.LT:
        return [iv - 1, iv - 2]
    if op is Op.LEQ:
        return [iv, iv - 1]
    return []


class _Unsat(Exception):
    pass


#: sentinel distinct from None for "write SQL NULL"
NULL_SENTINEL = object()


def _conjunctions(stmt, limit: int = 16):
    """Yield flat comparison lists covering ``stmt`` (one OR branch per
    disjunction, first branches first)."""
    from ..sql.predicate import Comparison, LogicalOperation

    if isinstance(stmt, Comparison):
        yield [stmt]
        return
    assert isinstance(stmt, LogicalOperation)
    kids = stmt.children
    name = stmt.op_type.name
    if name == "AND":
        def rec(i):
            if i == len(kids):
                yield []
                return
            for head in _conjunctions(kids[i], limit):
                for tail in rec(i + 1):
                    yield head + tail
        count = 0
        for combo in rec(0):
            yield combo
            count += 1
            if count >= limit:
                return
    elif name == "OR":
        for kid in kids:
            yield from _conjunctions(kid, limit)
    else:  # NOT: invert single-child comparisons where possible
        from ..sql.predicate import Op

        inv = {Op.EQ: Op.NEQ, Op.NEQ: Op.EQ, Op.LIKE: Op.NOT_LIKE,
               Op.NOT_LIKE: Op.LIKE, Op.IS_NULL: Op.IS_NOT_NULL,
               Op.IS_NOT_NULL: Op.IS_NULL, Op.LT: Op.GEQ, Op.GEQ: Op.LT,
               Op.GT: Op.LEQ, Op.LEQ: Op.GT}
        (kid,) = kids
        from ..sql.predicate import Comparison as _C

        if isinstance(kid, _C) and kid.op in inv:
            yield [_C(kid.column, inv[kid.op], kid.value)]


def _synthesize_filter(stmt, attrs, preset: Dict[int, object]) -> Dict[int, object]:
    """Column assignments satisfying ``stmt`` (a Statement over ``attrs``),
    honoring ``preset`` (join-column values that must not change).
    Returns {col_idx: value | NULL_SENTINEL}; raises _Unsat."""
    from ..sql.predicate import Comparison, like_match, Op

    if stmt is None:
        return {}
    for conj in _conjunctions(stmt):
        by_col: Dict[int, List[Comparison]] = {}
        for c in conj:
            by_col.setdefault(c.column, []).append(c)
        out: Dict[int, object] = {}
        ok = True
        for ci, cmps in by_col.items():
            dtype = attrs[ci][1]

            def passes(val, _ci=ci, _cmps=cmps):
                test = [None] * (_ci + 1)
                test[_ci] = None if val is NULL_SENTINEL else val
                return all(c.eval_row(test) for c in _cmps)

            if ci in preset:
                if passes(preset[ci]):
                    continue
                ok = False
                break
            # candidates: each comparison's candidates + pairwise LIKE
            # concatenations (multi-LIKE conjunctions on one column)
            cands: List = []
            for c in cmps:
                cands.extend(_synth_candidates(c, dtype))
            likes = [c for c in cmps if c.op is Op.LIKE]
            if len(likes) > 1 and dtype is DataType.VARCHAR:
                rng = np.random.default_rng(1)
                insts = [_instantiate_like(rng, c.value) for c in likes]
                cands.append(b"".join(insts))
                cands.append(b"".join(reversed(insts)))
            hit = next((v for v in cands if passes(v)), None)
            if hit is None:
                ok = False
                break
            out[ci] = hit
        if ok:
            return out
    raise _Unsat


def _plant_witnesses(gen: "SyntheticIMDB", tables: Dict[str, HostTable]) -> None:
    from ..sql.predicate import Op  # noqa: F401

    W = gen.witnesses
    alloc: Dict[str, int] = {}
    #: (table) -> list of (row, col_idx, value|NULL_SENTINEL)
    writes: Dict[str, List] = {}
    small_cache: Dict[Tuple, np.ndarray] = {}
    unsat: List[str] = []
    #: rows handed to some query's witnesses (their values WILL change):
    #: a later small-path anchor must never sit on one — its
    #: filter-passing check ran against pre-write data
    claimed: Dict[str, set] = {}
    #: small-path anchor rows (organic rows some query's correctness
    #: depends on): the allocator must never hand these out
    protected: Dict[str, set] = {}

    def alloc_rows(tname: str, k: int) -> List[int]:
        # Witness rows are EXCLUSIVE: the old modulo-wrap reused rows on
        # small tables, so a later query's writes clobbered an earlier
        # query's witnesses/anchors (masked by generator v6's 45%
        # literal mass; exposed by v7's realistic rates — e.g. 3b's
        # '%sequel%' keyword scan emptied at tiny scales). The cursor
        # skips protected anchor rows, and the table GROWS when it runs
        # out — a few hundred appended rows at worst, only at scales
        # where the table is tiny anyway.
        t = tables[tname]
        prot = protected.get(tname, set())
        out: List[int] = []
        cur = alloc.get(tname, 0)
        while len(out) < k:
            if cur >= t.num_rows:
                tables[tname] = t = _grow_table(
                    t, tname, t.num_rows + (k - len(out))
                )
            if cur not in prot:
                out.append(cur)
            cur += 1
        alloc[tname] = cur
        claimed.setdefault(tname, set()).update(out)
        return out

    for qi, parsed in enumerate(gen.parsed_queries):
        entities = list(dict.fromkeys(parsed.alias_map.values()))

        # join classes: DSU over (entity, column name)
        parent: Dict = {}

        def find(x):
            parent.setdefault(x, x)
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            parent[find(a)] = find(b)

        for a, nbrs in parsed.join_graph.items():
            for b, (ca, cb) in nbrs.items():
                union((a, ca), (b, cb))
        classes: Dict = {}
        for x in list(parent):
            classes.setdefault(find(x), []).append(x)

        # row selection. Small tables whose join columns are ALL their
        # own PK ("pure anchors": enum tables, filtered dimension
        # tables) reuse an existing filter-passing row — a 4-row enum
        # table cannot host 113x4 witnesses, and reusing keeps enum ids
        # meaningful. Everything else gets allocated (possibly
        # overwritten) rows, because its join columns must be REWRITTEN
        # to the class values (a small movie_link must still point at
        # the witness title, r1 bug: skipping writes severed chains).
        rows: Dict = {}
        small: Dict = {}
        for ent in entities:
            t = tables[ent.table]
            join_cols = [c for (e, c) in parent if e == ent]
            pure_anchor = all(c == "id" for c in join_cols)
            if t.num_rows < 5000 and pure_anchor:
                key = (ent.table, id(parsed.filters.get(ent)))
                passing = small_cache.get(key)
                if passing is None:
                    stmt = parsed.filters.get(ent)
                    mask = (np.asarray(stmt.eval_table(t), bool)
                            if stmt is not None
                            else np.ones(t.num_rows, bool))
                    passing = np.nonzero(mask)[0]
                    small_cache[key] = passing
                # anchors must sit on rows no query's witnesses claimed:
                # the passing mask was computed against pre-write data,
                # and claimed rows' values will change at apply time
                cl = claimed.get(ent.table, set())
                usable = [int(r) for r in passing if int(r) not in cl]
                if usable:
                    small[ent] = usable
                    rows[ent] = [usable[j % len(usable)]
                                 for j in range(W)]
                    protected.setdefault(ent.table, set()).update(
                        rows[ent]
                    )
                    continue
            rows[ent] = alloc_rows(ent.table, W)

        # class value per witness j: the id of the class's id-column
        # entity's witness row (ids are dense row+1)
        class_vals: Dict = {}
        for root, members in classes.items():
            id_ents = [e for (e, c) in members if c == "id"]
            if id_ents:
                anchor = id_ents[0]
            else:
                # no PK in class: anchor on any member's FK target
                anchor = None
            if anchor is not None:
                class_vals[root] = [rows[anchor][j] + 1 for j in range(W)]
            else:
                class_vals[root] = [j + 1 for j in range(W)]

        # per entity: join-column presets + filter synthesis
        for ent in entities:
            attrs = catalog.ATTRIBUTES[ent.table]
            col_of = {c: i for i, (c, _dt) in enumerate(attrs)}
            preset: Dict[int, object] = {}
            for (e, cname) in list(parent):
                if e != ent:
                    continue
                ci = col_of[cname]
                preset[ci] = class_vals[find((e, cname))]  # per-witness list
            if ent in small:
                continue  # existing row already passes; ids already align
            stmt = parsed.filters.get(ent)
            wl = writes.setdefault(ent.table, [])
            for j in range(W):
                preset_j = {
                    ci: v[j] for ci, v in preset.items()
                }
                try:
                    assign = _synthesize_filter(stmt, attrs, preset_j)
                except _Unsat:
                    unsat.append(f"{parsed.name or qi}:{ent}")
                    break
                r = rows[ent][j]
                for ci, v in preset_j.items():
                    if attrs[ci][0] != "id":
                        wl.append((r, ci, v))
                for ci, v in assign.items():
                    wl.append((r, ci, v))

    for tname, wl in writes.items():
        _apply_writes(tables[tname], wl)
    if unsat:
        import sys

        print(f"datagen: witness synthesis unsat for {sorted(set(unsat))}",
              file=sys.stderr)


def _grow_table(t: HostTable, tname: str, need: int) -> HostTable:
    """Append rows (cyclic copies of existing rows) until ``t`` has at
    least ``need`` rows; the ``id`` column stays a unique dense 1..n."""
    n = t.num_rows
    grow = need - n
    src = np.arange(grow, dtype=np.int64) % n
    idx = np.concatenate([np.arange(n, dtype=np.int64), src])
    cols = [c.take(idx) for c in t.columns]
    names = [c for c, _ in catalog.ATTRIBUTES[tname]]
    if "id" in names:
        ci = names.index("id")
        cols[ci].values[n:] = np.arange(n + 1, need + 1,
                                        dtype=cols[ci].values.dtype)
        cols[ci].valid[n:] = True
    return HostTable(need, cols)


def _apply_writes(table: HostTable, wl: List) -> None:
    """Apply (row, col, value|NULL_SENTINEL) writes; VARCHAR columns are
    rebuilt once via gather_varlen with the patch strings appended."""
    by_col: Dict[int, List] = {}
    for r, ci, v in wl:
        by_col.setdefault(ci, []).append((r, v))
    for ci, items in by_col.items():
        col = table.columns[ci]
        rows = np.fromiter((r for r, _ in items), np.int64, len(items))
        if col.dtype is not DataType.VARCHAR:
            vals = np.asarray(
                [0 if v is NULL_SENTINEL else int(v) for _, v in items],
                dtype=col.values.dtype,
            )
            col.values[rows] = vals
            col.valid[rows] = np.asarray(
                [v is not NULL_SENTINEL for _, v in items]
            )
            continue
        # VARCHAR: starts/lens patched to point into an appended patch heap
        lens = np.diff(col.ends, prepend=0)
        starts = col.ends - lens
        patch = b"".join(
            b"" if v is NULL_SENTINEL else v for _, v in items
        )
        base = len(col.heap)
        new_heap = np.concatenate([
            col.heap, np.frombuffer(patch, dtype=np.uint8).copy()
        ])
        off = 0
        valid = col.valid.copy()
        for (r, v) in items:
            if v is NULL_SENTINEL:
                starts[r] = 0
                lens[r] = 0
                valid[r] = False
            else:
                starts[r] = base + off
                lens[r] = len(v)
                valid[r] = True
                off += len(v)
        heap, ends = gather_varlen(new_heap, starts, lens)
        table.columns[ci] = HostColumn.varchar(heap, ends, valid)


#: bump when generator logic changes (invalidates the disk cache)
_GEN_VERSION = 9  # v9: real categorical selectivities (name.gender,
# cast_info.note) + length-decaying LIKE cold rates over the v7
# structure (flat 0.9 hot boost restored — the proportional v8 boost
# collapsed the intermediate distribution; see _gen_varchar_heap)


def generate_cached(
    scale: float,
    seed: int,
    queries: Optional[List[str]] = None,
    cache_dir: str = ".bench_cache",
) -> Dict[str, HostTable]:
    """Disk-cached :meth:`SyntheticIMDB.generate`.

    Scale-1.0 generation costs ~3 minutes of single-core numpy; the flat
    column arrays round-trip through one uncompressed .npz in seconds.
    Keyed by (scale, seed, query-literal hash, generator version)."""
    import hashlib
    import os

    h = hashlib.sha1()
    h.update(repr((_GEN_VERSION, scale, seed)).encode())
    for q in queries or []:
        h.update(q.encode())
    path = os.path.join(
        cache_dir, f"imdb_sf{scale}_s{seed}_{h.hexdigest()[:12]}.npz"
    )
    if os.path.exists(path):
        try:
            return _load_tables(path)
        except Exception:
            os.remove(path)  # corrupt/partial cache: regenerate
    tables = SyntheticIMDB(scale=scale, seed=seed, queries=queries).generate()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        # tmp name must end in .npz: np.savez appends the suffix otherwise,
        # and the replace() below would then target a nonexistent file
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        _save_tables(tmp, tables)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort (disk full etc.)
    return tables


def _save_tables(path: str, tables: Dict[str, HostTable]) -> None:
    arrays: Dict[str, np.ndarray] = {}
    for name, t in tables.items():
        for i, c in enumerate(t.columns):
            p = f"{name}/{i}/{int(c.dtype)}"
            arrays[f"{p}/valid"] = c.valid
            if c.dtype is DataType.VARCHAR:
                arrays[f"{p}/heap"] = c.heap
                arrays[f"{p}/ends"] = c.ends
            else:
                arrays[f"{p}/values"] = c.values
    np.savez(path, **arrays)  # uncompressed: load speed over size


def _load_tables(path: str) -> Dict[str, HostTable]:
    with np.load(path) as z:
        cols: Dict[str, Dict[int, HostColumn]] = {}
        by_prefix: Dict[str, Dict[str, str]] = {}
        for k in z.files:
            name, i, dt, kind = k.rsplit("/", 3)
            by_prefix.setdefault(f"{name}/{i}/{dt}", {})[kind] = k
        for prefix, kinds in by_prefix.items():
            name, i, dt = prefix.rsplit("/", 2)
            dtype = DataType(int(dt))
            valid = z[kinds["valid"]]
            if dtype is DataType.VARCHAR:
                col = HostColumn.varchar(z[kinds["heap"]], z[kinds["ends"]], valid)
            else:
                col = HostColumn(dtype, z[kinds["values"]], valid)
            cols.setdefault(name, {})[int(i)] = col
        return {
            name: HostTable(
                len(c[0].valid) if c else 0,
                [c[i] for i in sorted(c)],
            )
            for name, c in cols.items()
        }


def load_job_queries(sql_dir: str, names: List[str]) -> List[str]:
    out = []
    for name in names:
        with open(f"{sql_dir}/{name}.sql") as f:
            out.append(f.read())
    return out
