"""The node selector of the sort-based joins (joinbench/sort_nodes.py) and
its two readers, ``joins.sort_join_ms`` and ``joins.sort_join_roofline``,
on canned records and on the node shapes the program leaves on the CPU
route; the TPC-H cell's mix, its reference's imports, and the cell traced
on the CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from joinbench import node_bytes, run, sort_nodes
from joinbench.trace import Record, Request

MS = 1_000_000  # ns
H100 = "NVIDIA H100 80GB HBM3"


def _reader(name):
    path = os.path.join(run.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _shape(strategy, probe, build, out, cols, key=4, **extra):
    return {"strategy": strategy, "probe_rows": probe, "build_rows": build,
            "key_bytes": key, "out_rows": out, "out_col_bytes": cols,
            **extra}


def _record(card=H100):
    """Three requests: two of Q3's shape with node times (a unique_sort of
    lineitem against orders under a merge root), one from a program that
    leaves no node times."""
    t0 = 1_000 * MS
    q3 = {
        "node_shapes": {
            2: _shape("unique_sort", 97_000_000, 21_900_000, 4_500_000,
                      [4, 8, 8, 4, 4], sort_reason="window_cap",
                      window_log2=28),
            4: _shape("merge", 4_500_000, 900_000, 900_000, [4, 8, 8, 4, 4],
                      sort_reason="big_merge", window_log2=None),
            6: _shape("unique_scatter", 1_000, 10, 10, [4]),
        },
        "node_device_ms": {2: 30.0, 4: 5.0, 6: 0.5},
    }
    second = {"node_shapes": q3["node_shapes"],
              "node_device_ms": {2: 40.0, 4: 5.0, 6: 0.5}}
    reqs = [Request("q3", t0, t0 + 50 * MS, True, q3),
            Request("q3", t0 + 50 * MS, t0 + 100 * MS, True, second),
            Request("q3", t0 + 100 * MS, t0 + 120 * MS, True,
                    {"dispatch_ms": 1.0, "rounds": 2})]
    return Record(t0, t0 + 200 * MS, reqs, [], [], card)


def test_sort_nodes_pick_unique_sort_and_merge():
    stats = _record().requests[0].stats
    got = list(sort_nodes.sort_nodes(stats))
    assert [s["strategy"] for _ms, s in got] == ["unique_sort", "merge"]
    assert [ms for ms, _s in got] == [30.0, 5.0]
    assert list(sort_nodes.sort_nodes(None)) == []
    assert list(sort_nodes.sort_nodes({"node_shapes": stats["node_shapes"]})
                ) == []


def test_sort_join_ms():
    # the sort nodes' sums, 35 and 45 ms, over the two requests that
    # report node times; the unique_scatter node is no sort
    assert _reader("joins.sort_join_ms")(_record()) == pytest.approx(40.0)


def test_sort_join_roofline():
    shapes = _record().requests[0].stats["node_shapes"]
    least = 2 * (node_bytes.least_bytes(shapes[2])
                 + node_bytes.least_bytes(shapes[4]))
    want = 100.0 * least / 3.35e12 / 80e-3
    got = _reader("joins.sort_join_roofline")(_record())
    assert got == pytest.approx(want) and 0 < got < 100
    assert _reader("joins.sort_join_roofline")(_record("cpu")) is None


@pytest.mark.parametrize("name", ["joins.sort_join_ms",
                                  "joins.sort_join_roofline"])
def test_readers_find_nothing_without_node_times(name):
    """A program that leaves no ``node_device_ms`` (the CPU route, or a
    parent without node timing) gives no value, and nothing raises."""
    rec = _record()
    for req in rec.requests:
        if req.stats:
            req.stats = {k: v for k, v in req.stats.items()
                         if k != "node_device_ms"}
    assert _reader(name)(rec) is None
    assert _reader(name)(Record(0, 1, [], [], [], H100)) is None
    assert _reader(name)(Record(0, 1, [Request("q", 0, 1, False, None)],
                                [], [], H100)) is None


def test_readers_read_the_programs_shapes():
    """With the sort-based unique join forced, the readers read the shapes
    the port leaves for TPC-H's Q3 on the CPU route."""
    import radixjoin_tpu_torch as port
    from joinbench.configs import tpch_sf30 as cfg

    tables = cfg.generate(11, scale=0.002)
    plan = cfg.build_plans(tables, ["q3"])["q3"]
    old = os.environ.get("RJT_UNIQUE_JOIN")
    os.environ["RJT_UNIQUE_JOIN"] = "sort"
    try:
        port.execute(plan, port.build_context("cpu"))
    finally:
        if old is None:
            del os.environ["RJT_UNIQUE_JOIN"]
        else:
            os.environ["RJT_UNIQUE_JOIN"] = old
    stats = plan._last_exec_stats
    assert "node_device_ms" not in stats
    shapes = stats["node_shapes"]
    sorts = [s for s in shapes.values() if s["strategy"] in sort_nodes.SORT]
    assert [s["sort_reason"] for s in sorts] == ["knob"]
    stats = dict(stats, node_device_ms={n: 2.0 for n in shapes})
    rec = Record(0, 1, [Request("q3", 0, 1, True, stats)], [], [], H100)
    assert _reader("joins.sort_join_ms")(rec) == pytest.approx(2.0)
    assert _reader("joins.sort_join_roofline")(rec) == pytest.approx(
        100.0 * sum(map(node_bytes.least_bytes, sorts)) / 3.35e12 / 2e-3)


def test_the_tpch_mix_names_its_plans():
    from joinbench.configs import tpch_sf30

    with open(os.path.join(run.HERE, "traffic",
                           "serial_resident_q3_q8.json")) as f:
        traffic = json.load(f)
    assert traffic["plans"] == ["q3", "q8"]
    assert set(traffic["plans"]) <= set(tpch_sf30.CONFIG["plans"])
    assert (traffic["driver"], traffic["inputs"],
            traffic["warmup_passes"]) == ("closed_loop", "resident", 2)


def test_tpch_reference_loads_nothing_of_the_program():
    code = ("import json, os, sys\n"
            "from joinbench import run\n"
            "run.load_module(os.path.join(run.HERE, 'reference', "
            "'tpch_sf30.py'), 'ref_tpch')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
            "                        & {'radixjoin_tpu_torch', 'radixjoin_tpu',\n"
            "                           'jax', 'jaxlib'})))\n")
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env, check=True).stdout
    assert json.loads(out) == []


def test_tpch_cell_traced_on_cpu():
    out = run.run_cell(run.ROOT, "tpch_sf30.resident_q3_q8", 2 ** 32 + 5,
                       0.3, True, device="cpu", scale=0.002)
    assert out["correct"] is True and out["failed"] == 0
    # no node times on the CPU: the two readers leave their metrics out
    assert not {"joins.sort_join_ms", "joins.sort_join_roofline"} & set(
        out["metrics"])

