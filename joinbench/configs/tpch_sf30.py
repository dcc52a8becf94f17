"""tpch_sf30: TPC-H (TPC Benchmark H Standard Specification revision 3.0.1)
at scale factor 30 on one card: a 180 M-row ``lineitem`` joined to a 45
M-row ``orders`` on ``o_orderkey``, whose keys fill 8 of every 32 and so
span a 2^28 key window, past every dense join strategy's cap.

The five query documents (Q3, Q8, Q10, Q12 and Q14 of Clause 2.4 as
printed, with the validation parameters, and for each an EXPLAIN-JSON tree
of PostgreSQL's shape: a left-deep Hash Join chain probing ``lineitem``, a
Hash over each other table, the most selective first, under Limit / Sort /
Aggregate) are in ``tpch_sf30.documents.json``; the schema, with the
specification's column names and the type each is held in, in
``tpch_sf30.schema.json``. Plans are built at set-up through the port's SQL
entry point with that schema as the catalog: parse, filter each table,
page it, convert the EXPLAIN tree. The root carries every column the
select list, GROUP BY and ORDER BY read; aggregation, ordering and the
LIMIT stay with the caller.
"""

import functools
import json
import os

import numpy as np

from radixjoin_tpu_torch import Column, ColumnarTable, DataType
from radixjoin_tpu_torch.plan.ir import ScanNode
from radixjoin_tpu_torch.sql import Catalog, ParsedSQL, plan_from_explain
from radixjoin_tpu_torch.storage import host_pool
from radixjoin_tpu_torch.storage.columnar import HostTable

from joinbench import tpch_datagen

_HERE = os.path.dirname(os.path.abspath(__file__))

CONFIG = {
    "name": "tpch_sf30",
    "source": "TPC-H Standard Specification rev. 3.0.1 (TPC), scale factor 30: join queries "
              "Q3, Q8, Q10, Q12, Q14 with the validation parameters of Clause 2.4; data per Clause 4.2",
    "reduced": [],
    "assumed": [
        "a seeded NumPy generator (joinbench/tpch_datagen.py) with the row counts and rules of "
        "Clause 4.2 stands in for dbgen; comments and addresses are random letters and digits of "
        "the specification's lengths, not its text grammar",
        "the columns no query of the five reads (not_generated in tpch_sf30.schema.json: partsupp "
        "whole, and l_linenumber, l_quantity, l_tax, l_linestatus, l_shipinstruct, l_comment, "
        "o_orderstatus, o_totalprice, o_clerk, o_comment, six of part's, five of supplier's, "
        "n_comment, r_comment) are not generated",
        "the EXPLAIN trees are written by hand in PostgreSQL's shape (there is no PostgreSQL here)",
        "types: IDENTIFIER and INTEGER are INT32, DATE INT32 days since 1970-01-01, DECIMAL(15,2) "
        "FP64, CHAR(n) and VARCHAR(n) VARCHAR",
        "inputs are pages with no host twin, as job5_imdb_sf1's; the columns the plans scan are "
        "paged at set-up, the others only where the program reads them",
    ],
    "guarantees": [
        "exact results: the row multiset of every output column, NULLs included, equals the plain reference's",
        "SQL semantics: a comparison with NULL is not true, a NULL key joins nothing",
    ],
    "scale": 30,
    # a seeded two of each plan's first four results are compared whole;
    # every row count is compared
    "check_sample": {"per_plan": 2, "among_first": 4},
    "plans": ["q3", "q8", "q10", "q12", "q14"],
}

#: the generated columns of the schema, as the port's SQL front end reads it
CATALOG = Catalog({t: [(c, DataType[dt]) for c, dt in cols]
                   for t, cols in tpch_datagen.COLUMNS.items()})


def documents():
    with open(os.path.join(_HERE, "tpch_sf30.documents.json")) as f:
        return json.load(f)["documents"]


def generate(seed: int, scale: float = CONFIG["scale"]):
    """name -> HostTable of the configuration's tables. The documents are
    parsed first, so a front end that cannot read them fails before the
    minute the generator takes at scale 30."""
    docs = documents()
    for name in CONFIG["plans"]:
        ParsedSQL(docs[name]["sql"], name, catalog=CATALOG)
    return tpch_datagen.generate(seed, scale)


def _pages(col, rows):
    """The pages of ``col``, or of its ``rows`` where given."""
    if rows is not None:
        col = col.take(rows)
    return ColumnarTable.from_host(HostTable(len(col), [col])).columns[0].pages


def build_plans(tables, names=CONFIG["plans"]):
    """name -> Plan of the documents ``names``: each document's inputs
    filtered by its WHERE clause and paged, with no host twin. A table
    scanned unfiltered (``lineitem`` in Q8) is one table object shared by
    every plan that scans it, and so is one filtered alike (Q3's and Q8's
    ``orders`` are not: their dates differ), so the card holds it once. A
    column is paged when it is first read (``Column`` takes a callable);
    the columns the plans scan are read here, all at once, so set-up pages
    those and no other (at SF 30, 8 of ``lineitem``'s 20 column copies)."""
    shared = {}

    def provider(entity, _attributes, filt):
        key = (entity.table, None if filt is None else filt.pretty())
        if key not in shared:
            host = tables[entity.table]
            rows = None if filt is None else np.flatnonzero(
                filt.eval_table(host))
            shared[key] = ColumnarTable(
                host.num_rows if rows is None else len(rows),
                [Column(c.dtype, functools.partial(_pages, c, rows))
                 for c in host.columns])
        return shared[key]

    docs = documents()
    plans = {}
    for name in names:
        parsed = ParsedSQL(docs[name]["sql"], name, catalog=CATALOG)
        plans[name] = plan_from_explain(docs[name]["explain"]["Plan"], parsed,
                                        provider)
    scanned = {}
    for plan in plans.values():
        for node in plan.nodes:
            if isinstance(node.data, ScanNode):
                table = plan.inputs[node.data.base_table_id]
                for ci, _dt in node.output_attrs:
                    scanned[id(table.columns[ci])] = table.columns[ci]
    host_pool.parallel_map(lambda c: c.pages, list(scanned.values()))
    return plans
