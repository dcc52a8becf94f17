"""The least-bytes rule of a join node (joinbench/node_bytes.py) and the
two readers of the unique-key probes, ``joins.unique_probe_ms`` and
``joins.unique_probe_roofline``, on canned records and on the node shapes
the program leaves on the CPU route."""

import importlib.util
import os

import pytest

from joinbench import node_bytes, run
from joinbench.trace import Record, Request

MS = 1_000_000  # ns
H100 = "NVIDIA H100 80GB HBM3"


def _reader(name):
    path = os.path.join(run.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _shape(strategy, probe, build, out, cols, key=4):
    return {"strategy": strategy, "probe_rows": probe, "build_rows": build,
            "key_bytes": key, "out_rows": out, "out_col_bytes": cols}


def test_least_bytes_of_a_node():
    # probe 1,000 x (4 + 1) + build 10 x 5 + out 100 x (2 x 5 + 2 x 9)
    assert node_bytes.least_bytes(_shape("unique_scatter", 1000, 10, 100,
                                         [4, 8])) == 5000 + 50 + 2800
    assert node_bytes.least_bytes(_shape("csr", 0, 0, 0, [4], key=8)) == 0
    assert node_bytes.least_bytes(_shape("merge", 3, 2, 1, [], key=8)) == 45


def _record(card=H100):
    """Three requests: two with node times (a star of two unique probes
    under a csr root), one from a program that leaves no node times."""
    t0 = 1_000 * MS
    star = {
        "node_shapes": {
            2: _shape("unique_scatter", 120_000_000, 1_000, 480_000, [4] * 4),
            4: _shape("unique_sort", 480_000, 8_000, 24_000, [4] * 3),
            6: _shape("csr", 24_000, 2_556, 24_000, [4] * 3),
        },
        "node_device_ms": {2: 1.0, 4: 0.25, 6: 0.5},
    }
    second = {"node_shapes": star["node_shapes"],
              "node_device_ms": {2: 2.0, 4: 0.75, 6: 0.5}}
    reqs = [Request("q2_3", t0, t0 + 5 * MS, True, star),
            Request("q2_3", t0 + 5 * MS, t0 + 9 * MS, True, second),
            Request("q2_3", t0 + 9 * MS, t0 + 12 * MS, True,
                    {"dispatch_ms": 1.0, "rounds": 2})]
    return Record(t0, t0 + 20 * MS, reqs, [], [], card)


def test_unique_probe_ms():
    # the unique nodes' sums, 1.25 and 2.75 ms, over the two requests
    # that report node times; the csr root is not a probe
    assert _reader("joins.unique_probe_ms")(_record()) == pytest.approx(2.0)


def test_unique_probe_roofline():
    shapes = _record().requests[0].stats["node_shapes"]
    least = 2 * (node_bytes.least_bytes(shapes[2])
                 + node_bytes.least_bytes(shapes[4]))
    want = 100.0 * least / 3.35e12 / (4.0e-3)
    got = _reader("joins.unique_probe_roofline")(_record())
    assert got == pytest.approx(want) and 0 < got < 100
    assert _reader("joins.unique_probe_roofline")(_record("cpu")) is None


@pytest.mark.parametrize("name", ["joins.unique_probe_ms",
                                  "joins.unique_probe_roofline"])
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


def test_least_bytes_of_the_programs_shapes():
    """The rule reads the shapes the port leaves on the CPU route."""
    import radixjoin_tpu_torch as port
    from joinbench.configs import ssb_sf20 as cfg

    tables = cfg.generate(7, scale=0.002)
    plan = cfg.build_plans(tables, ["q4_3"])["q4_3"]
    ctx = port.build_context("cpu")
    port.execute(plan, ctx)
    stats = plan._last_exec_stats
    assert "node_device_ms" not in stats
    shapes = stats["node_shapes"]
    lo_rows = tables["lineorder"].num_rows
    probes = [s for s in shapes.values() if s["strategy"] in node_bytes.UNIQUE]
    assert len(probes) == 3 and max(s["probe_rows"] for s in probes) == lo_rows
    for s in shapes.values():
        assert s["key_bytes"] == 4
        assert node_bytes.least_bytes(s) >= s["probe_rows"] * 5
    # with node times the two readers read the program's own shapes
    stats = dict(stats, node_device_ms={n: 1.0 for n in shapes})
    rec = Record(0, 1, [Request("q4_3", 0, 1, True, stats)], [], [], H100)
    assert _reader("joins.unique_probe_ms")(rec) == pytest.approx(3.0)
    assert _reader("joins.unique_probe_roofline")(rec) == pytest.approx(
        100.0 * sum(map(node_bytes.least_bytes, probes)) / 3.35e12 / 3e-3)
