"""ssb_sf20: the Star Schema Benchmark (O'Neil et al., TPCTC 2009,
specification revision 3) at scale factor 20, the single-GPU setting of
Crystal (Shanbhag, Madden and Yu, SIGMOD 2020): the whole star schema on one
card, every query probing the 120 M-row ``lineorder`` against filtered
dimensions.

The 13 query documents (SSB's SQL texts as published, and for each an
EXPLAIN-JSON tree of PostgreSQL's shape for a star join: a left-deep Hash
Join chain probing ``lineorder``, the most selective dimension first, under
Sort / Aggregate) are in ``ssb_sf20.documents.json``; the schema, with the
specification's column names and types, in ``ssb_sf20.schema.json``. Plans
are built at set-up through the port's SQL entry point with that schema as
the catalog: parse, filter each table, page it, convert the EXPLAIN tree.
The root carries every column the select list, GROUP BY and ORDER BY read;
aggregation and ordering stay with the caller.
"""

import json
import os

from radixjoin_tpu_torch import Column, ColumnarTable, DataType
from radixjoin_tpu_torch.sql import Catalog, ParsedSQL, plan_from_explain
from radixjoin_tpu_torch.storage import ingest

from joinbench import ssb_datagen

_HERE = os.path.dirname(os.path.abspath(__file__))

CONFIG = {
    "name": "ssb_sf20",
    "source": "Star Schema Benchmark, O'Neil et al., TPCTC 2009 (SSB spec rev. 3), "
              "at scale factor 20, the single-GPU setting of Crystal (Shanbhag et al., SIGMOD 2020)",
    "reduced": [],
    "assumed": [
        "a seeded NumPy generator (joinbench/ssb_datagen.py) with the specification's row counts "
        "and value sets stands in for dbgen",
        "the lineorder columns no query reads (lo_orderpriority, lo_shippriority, lo_ordtotalprice, "
        "lo_tax, lo_commitdate, lo_shipmode) are not generated",
        "the EXPLAIN trees are written by hand in PostgreSQL's shape (there is no PostgreSQL here)",
        "inputs are eager pages with no host twin, as job5_imdb_sf1's",
    ],
    "guarantees": [
        "exact results: the row multiset of every output column, NULLs included, equals the plain reference's",
        "SQL semantics: a comparison with NULL is not true, a NULL key joins nothing",
    ],
    "scale": 20,
    # a seeded two of each plan's first four results are compared whole;
    # every row count is compared
    "check_sample": {"per_plan": 2, "among_first": 4},
    "plans": ["q1_1", "q1_2", "q1_3", "q2_1", "q2_2", "q2_3", "q3_1", "q3_2",
              "q3_3", "q3_4", "q4_1", "q4_2", "q4_3"],
}

#: the generated columns of the schema, as the port's SQL front end reads it
CATALOG = Catalog({t: [(c, DataType[dt]) for c, dt in cols]
                   for t, cols in ssb_datagen.COLUMNS.items()})


def documents():
    with open(os.path.join(_HERE, "ssb_sf20.documents.json")) as f:
        return json.load(f)["documents"]


def generate(seed: int, scale: float = CONFIG["scale"]):
    """name -> HostTable of the configuration's tables."""
    return ssb_datagen.generate(seed, scale)


def build_plans(tables, names=CONFIG["plans"]):
    """name -> Plan of the documents ``names``: each document's inputs
    filtered by its WHERE clause and paged, with no host twin. A table
    scanned unfiltered (``lineorder`` in the drill-downs) is one table
    object shared by every plan that scans it, so the card holds it once."""
    shared = {}

    def resident(host):
        # the pages alone: new column objects, and no host twin
        table = ColumnarTable.from_host(host)
        return ColumnarTable(table.num_rows, [
            Column(c.type, c.pages) for c in table.columns])

    def provider(entity, _attributes, filt):
        if filt is not None:
            return resident(ingest.filter_table(tables[entity.table], filt))
        if entity.table not in shared:
            shared[entity.table] = resident(tables[entity.table])
        return shared[entity.table]

    docs = documents()
    plans = {}
    for name in names:
        parsed = ParsedSQL(docs[name]["sql"], name, catalog=CATALOG)
        plans[name] = plan_from_explain(docs[name]["explain"]["Plan"], parsed,
                                        provider)
    return plans
