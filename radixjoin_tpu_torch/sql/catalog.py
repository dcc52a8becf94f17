"""Schema catalogs of the SQL front end.

A :class:`Catalog` is one schema: each table's ordered, typed columns and
the column -> tables reverse map that resolves unqualified column
references (reference tests/read_sql.cpp:1263-1275). :data:`IMDB`, the
default of :class:`~.frontend.ParsedSQL` and
:func:`~.explain.plan_from_explain`, is the 21-table IMDB schema of the
Join Order Benchmark, with the same type mapping the reference harness
hardcodes (reference tests/read_sql.cpp:21-139, derived from
job/schema.sql: ``integer`` -> INT32, ``text``/``character varying`` ->
VARCHAR). Another schema is passed as a ``Catalog`` of its own; the
module-level names are IMDB's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..dtypes import DataType

_I = DataType.INT32
_V = DataType.VARCHAR

# table -> ordered list of (column_name, type)
ATTRIBUTES: Dict[str, List[Tuple[str, DataType]]] = {
    "aka_name": [
        ("id", _I), ("person_id", _I), ("name", _V), ("imdb_index", _V),
        ("name_pcode_cf", _V), ("name_pcode_nf", _V), ("surname_pcode", _V),
        ("md5sum", _V),
    ],
    "aka_title": [
        ("id", _I), ("movie_id", _I), ("title", _V), ("imdb_index", _V),
        ("kind_id", _I), ("production_year", _I), ("phonetic_code", _V),
        ("episode_of_id", _I), ("season_nr", _I), ("episode_nr", _I),
        ("note", _V), ("md5sum", _V),
    ],
    "cast_info": [
        ("id", _I), ("person_id", _I), ("movie_id", _I), ("person_role_id", _I),
        ("note", _V), ("nr_order", _I), ("role_id", _I),
    ],
    "char_name": [
        ("id", _I), ("name", _V), ("imdb_index", _V), ("imdb_id", _I),
        ("name_pcode_nf", _V), ("surname_pcode", _V), ("md5sum", _V),
    ],
    "comp_cast_type": [("id", _I), ("kind", _V)],
    "company_name": [
        ("id", _I), ("name", _V), ("country_code", _V), ("imdb_id", _I),
        ("name_pcode_nf", _V), ("name_pcode_sf", _V), ("md5sum", _V),
    ],
    "company_type": [("id", _I), ("kind", _V)],
    "complete_cast": [
        ("id", _I), ("movie_id", _I), ("subject_id", _I), ("status_id", _I),
    ],
    "info_type": [("id", _I), ("info", _V)],
    "keyword": [("id", _I), ("keyword", _V), ("phonetic_code", _V)],
    "kind_type": [("id", _I), ("kind", _V)],
    "link_type": [("id", _I), ("link", _V)],
    "movie_companies": [
        ("id", _I), ("movie_id", _I), ("company_id", _I),
        ("company_type_id", _I), ("note", _V),
    ],
    "movie_info_idx": [
        ("id", _I), ("movie_id", _I), ("info_type_id", _I), ("info", _V),
        ("note", _V),
    ],
    "movie_keyword": [("id", _I), ("movie_id", _I), ("keyword_id", _I)],
    "movie_link": [
        ("id", _I), ("movie_id", _I), ("linked_movie_id", _I),
        ("link_type_id", _I),
    ],
    "name": [
        ("id", _I), ("name", _V), ("imdb_index", _V), ("imdb_id", _I),
        ("gender", _V), ("name_pcode_cf", _V), ("name_pcode_nf", _V),
        ("surname_pcode", _V), ("md5sum", _V),
    ],
    "role_type": [("id", _I), ("role", _V)],
    "title": [
        ("id", _I), ("title", _V), ("imdb_index", _V), ("kind_id", _I),
        ("production_year", _I), ("imdb_id", _I), ("phonetic_code", _V),
        ("episode_of_id", _I), ("season_nr", _I), ("episode_nr", _I),
        ("series_years", _V), ("md5sum", _V),
    ],
    "movie_info": [
        ("id", _I), ("movie_id", _I), ("info_type_id", _I), ("info", _V),
        ("note", _V),
    ],
    "person_info": [
        ("id", _I), ("person_id", _I), ("info_type_id", _I), ("info", _V),
        ("note", _V),
    ],
}


class Catalog:
    """One schema: ``attributes`` (table -> ordered ``(column, type)``) and
    ``column_to_tables`` (column name -> the tables that have it, for
    unqualified references)."""

    def __init__(self, attributes: Dict[str, List[Tuple[str, DataType]]]):
        self.attributes = attributes
        self.column_to_tables: Dict[str, List[str]] = {}
        for table, attrs in self.attributes.items():
            for name, _ in attrs:
                self.column_to_tables.setdefault(name, []).append(table)

    def __contains__(self, table: str) -> bool:
        return table in self.attributes

    def column_index(self, table: str, column: str) -> int:
        attrs = self.attributes.get(table)
        if attrs is None:
            raise KeyError(f"no table {table!r} in catalog")
        for idx, (name, _) in enumerate(attrs):
            if name == column:
                return idx
        raise KeyError(f"no column {column!r} in table {table!r}")

    def column_type(self, table: str, column: str) -> DataType:
        return self.attributes[table][self.column_index(table, column)][1]

    def column_names(self, table: str) -> List[str]:
        return [name for name, _ in self.attributes[table]]

    def column_types(self, table: str) -> List[DataType]:
        return [t for _, t in self.attributes[table]]


#: the JOB / IMDB schema, the default catalog
IMDB = Catalog(ATTRIBUTES)
# column name -> list of tables containing it (for unqualified references)
COLUMN_TO_TABLES: Dict[str, List[str]] = IMDB.column_to_tables
column_index = IMDB.column_index
column_type = IMDB.column_type
column_names = IMDB.column_names
column_types = IMDB.column_types
