"""Randomized join plans for the fuzz campaign (own copy of the generator of
the JAX package's tests/test_fuzz_plans.py, building the port's ``Plan``
and ``ColumnarTable``).

:func:`gen_plan` draws from ``rng`` in the same order as the JAX test's
generator, so ``gen_plan(np.random.default_rng(seed))`` gives the same
plan in both packages: the same input rows and types, nodes, attributes,
build sides and root. The plans sweep the whole semantic surface at once:
every key dtype, NULL keys and payloads, duplicate and skewed keys, empty
inputs, type-mismatched join keys (which never match), both build sides,
multi-join trees and random projections with columns reordered across
sides.
"""

from __future__ import annotations

from ..dtypes import NULL, DataType
from ..plan.ir import Plan
from ..storage.columnar import ColumnarTable, HostTable

I32 = DataType.INT32
I64 = DataType.INT64
F64 = DataType.FP64
VC = DataType.VARCHAR
DTYPES = [I32, I64, F64, VC]

# Small vocabularies force duplicate keys (fan-out) and cross-table
# matches; the extremes exercise value-range and long-string paths.
_VOCAB = [b"", b"a", b"abc", b"Movie (2001)", b"\xe9clair", b"x" * 300]
_F64S = [0.0, -0.0, 1.5, -2.25, 3.0, 1e300]


def _gen_value(rng, dt):
    if rng.random() < 0.15:
        return NULL
    r = rng.random()
    if dt is I32:
        return int(rng.integers(-3, 9)) if r < 0.95 else int(2**31 - 1)
    if dt is I64:
        return int(rng.integers(-3, 9)) if r < 0.9 else -(2**62)
    if dt is F64:
        if r < 0.9:
            return float(_F64S[rng.integers(0, len(_F64S))])
        return float("nan")
    return _VOCAB[rng.integers(0, len(_VOCAB))]


def gen_plan(rng) -> Plan:
    """Random binary join tree over 2-4 base tables."""
    plan = Plan()
    table_types = []
    for _ in range(int(rng.integers(2, 5))):
        types = [DTYPES[rng.integers(0, 4)]
                 for _ in range(int(rng.integers(1, 4)))]
        nrows = int(rng.choice([0, 1, 7, 40, 90],
                               p=[0.06, 0.1, 0.3, 0.34, 0.2]))
        rows = [tuple(_gen_value(rng, t) for t in types) for _ in range(nrows)]
        plan.new_input(ColumnarTable.from_host(HostTable.from_rows(rows, types)))
        table_types.append(types)

    nodes = []  # (node_id, output dtypes)
    for tid, types in enumerate(table_types):
        sel = rng.permutation(len(types))[: int(rng.integers(1, len(types) + 1))]
        attrs = [(int(c), types[int(c)]) for c in sel]
        nodes.append((plan.new_scan_node(tid, attrs), [t for _, t in attrs]))

    while len(nodes) > 1:
        i, j = (int(x) for x in rng.choice(len(nodes), 2, replace=False))
        (ln, lt), (rn, rt) = nodes[i], nodes[j]
        matched = [
            (a, b) for a in range(len(lt)) for b in range(len(rt))
            if lt[a] is rt[b]
        ]
        if matched and rng.random() > 0.07:
            la, ra = matched[rng.integers(0, len(matched))]
        else:  # mismatched key dtypes: join must be statically empty
            la = int(rng.integers(0, len(lt)))
            ra = int(rng.integers(0, len(rt)))
        combined = lt + rt
        sel = rng.permutation(len(combined))[
            : int(rng.integers(1, min(len(combined), 5) + 1))
        ]
        attrs = [(int(c), combined[int(c)]) for c in sel]
        nid = plan.new_join_node(
            bool(rng.random() < 0.5), ln, rn, la, ra, attrs
        )
        nodes = [nodes[k] for k in range(len(nodes)) if k not in (i, j)]
        nodes.append((nid, [t for _, t in attrs]))

    plan.root = nodes[0][0]
    plan.validate()
    return plan


def mask_nan(rows):
    """Rows with every NaN replaced by a marker byte-string: NaN != NaN
    breaks a Counter-based multiset comparison, and NaN payload values are
    legal in outputs."""
    return [
        tuple(b"\x00NaN" if isinstance(v, float) and v != v else v for v in r)
        for r in rows
    ]
