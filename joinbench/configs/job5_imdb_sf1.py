"""job5_imdb_sf1: five JOB-shaped queries over IMDB at scale 1.0, as the
SIGMOD 2025 Programming Contest runs JOB: each query's inputs are filtered
and paged before the timed ``execute``.

The five query documents (SQL text and EXPLAIN-JSON tree, in
``job5_imdb_sf1.documents.json``) are those of the port's
``harness/job_shapes.py``: ``q1a`` (JOB 1a: LIKE, NOT LIKE and IN filters
over five tables), ``q_or`` (OR filters within one table), ``q_alias``
(``title`` under two aliases), ``q_varchar`` (a join on a VARCHAR key,
which the fused executor serves at this scale) and ``q6a`` (JOB 6a: a selective join
chain that probes the unfiltered 36.2 M-row ``cast_info``). Their
literals, which the generator mixes into the filtered columns, are data
(``job5_imdb_sf1.literals.json``). Plans are built at set-up through the
port's SQL entry point: parse, filter each table, page it, convert the
EXPLAIN tree.
"""

import json
import os

from radixjoin_tpu_torch import Column, ColumnarTable
from radixjoin_tpu_torch.sql import ParsedSQL, plan_from_explain
from radixjoin_tpu_torch.storage import ingest

from joinbench import datagen

_HERE = os.path.dirname(os.path.abspath(__file__))

CONFIG = {
    "name": "job5_imdb_sf1",
    "source": "SIGMOD 2025 Programming Contest (JOB over IMDB; execute() timed over pre-filtered paged inputs) "
              "and JOB (Leis et al., VLDB 2015) at IMDB's row counts, scale 1.0",
    "reduced": [],
    "assumed": [
        "the synthetic IMDB (joinbench/datagen.py with the documents' literals) stands in for the real dump",
        "five JOB-shaped query documents stand in for the 113 queries, whose files are not in the repository",
        "inputs are eager pages with no host twin (the contest's paged contract), "
        "as the port's harness/run.py builds them under RJT_EAGER_PAGES=on",
    ],
    "guarantees": [
        "exact results: the row multiset of every output column, NULLs included, equals the plain reference's",
        "SQL semantics: a comparison or LIKE with NULL is not true, a NULL key joins nothing",
    ],
    "scale": 1.0,
    "tables": ["company_type", "info_type", "movie_companies", "movie_info_idx",
               "title", "keyword", "movie_keyword", "link_type", "movie_link",
               "company_name", "cast_info", "name"],
    # a seeded two of each plan's first four results are compared whole
    # (a q_varchar result is 23 M rows); every row count is compared
    "check_sample": {"per_plan": 2, "among_first": 4},
    "plans": ["q1a", "q_or", "q_alias", "q_varchar", "q6a"],
}


def documents():
    with open(os.path.join(_HERE, "job5_imdb_sf1.documents.json")) as f:
        return json.load(f)["documents"]


def generate(seed: int, scale: float = CONFIG["scale"]):
    """name -> HostTable of the configuration's tables."""
    literals = datagen.Literals.load(
        os.path.join(_HERE, "job5_imdb_sf1.literals.json"))
    return datagen.SyntheticIMDB(scale=scale, seed=seed,
                                 literals=literals).generate(CONFIG["tables"])


def build_plans(tables, names=CONFIG["plans"]):
    """name -> Plan of the documents ``names``: each document's inputs
    filtered by its WHERE clause and paged, with no host twin."""
    paged = {}

    def provider(entity, _attributes, filt):
        if filt is None:
            if entity.table not in paged:
                paged[entity.table] = ColumnarTable.from_host(
                    tables[entity.table])
            table = paged[entity.table]
        else:
            table = ColumnarTable.from_host(
                ingest.filter_table(tables[entity.table], filt))
        # new column objects over the same page bytes, and no host twin
        return ColumnarTable(table.num_rows, [
            Column(c.type, c.pages) for c in table.columns])

    docs = documents()
    plans = {}
    for name in names:
        parsed = ParsedSQL(docs[name]["sql"], name)
        plans[name] = plan_from_explain(docs[name]["explain"]["Plan"], parsed,
                                        provider)
    return plans
