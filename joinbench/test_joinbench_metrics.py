"""Each per-layer reader on a canned record of a traced window, and the
trace's breakdown."""

import importlib.util
import json
import os

import pytest

from joinbench import run
from joinbench.stats import Window, percentile
from joinbench.trace import DeviceEvent, Record, Request, breakdown

MS = 1_000_000  # ns


def _reader(name, folder="metrics"):
    path = os.path.join(run.HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record(card="NVIDIA H100 80GB HBM3"):
    """Two requests in a 100 ms window: a fused one with its fetches and
    encode, a wave one; and the device events the profiler would give."""
    t0 = 1_000 * MS
    reqs = [
        Request("q1", t0 + 0, t0 + 40 * MS, True,
                {"dispatch_ms": 4.0, "fetch_ms": 10.0, "decode_ms": 2.0,
                 "rounds": 2},
                fetches=[(t0 + 5 * MS, t0 + 10 * MS), (t0 + 20 * MS, t0 + 25 * MS)],
                encode=(t0 + 30 * MS, t0 + 38 * MS)),
        Request("q2", t0 + 50 * MS, t0 + 90 * MS, True,
                {"dispatch_ms": 6.0, "fetch_ms": 20.0, "decode_ms": 4.0,
                 "rounds": 3},
                fetches=[(t0 + 55 * MS, t0 + 60 * MS)],
                encode=(t0 + 70 * MS, t0 + 72 * MS)),
    ]
    ev = [
        DeviceEvent("Memcpy HtoD (Pageable -> Device)", "htod", t0 + 1 * MS, t0 + 3 * MS),
        DeviceEvent("void paged_gather_kernel<true>(int const*)", "kernel", t0 + 3 * MS, t0 + 4 * MS),
        DeviceEvent("void at::native::radixSortKVInPlace(...)", "kernel", t0 + 4 * MS, t0 + 7 * MS),
        DeviceEvent("bwg_kernel(RjtTables, int)", "kernel", t0 + 7 * MS, t0 + 8 * MS),
        DeviceEvent("Memcpy DtoH (Device -> Pageable)", "dtoh", t0 + 8 * MS, t0 + 10 * MS),
        DeviceEvent("void owner_merge_kernel<int, 4>(...)", "kernel", t0 + 56 * MS, t0 + 57 * MS),
        DeviceEvent("Memset (Device)", "memset", t0 + 57 * MS, t0 + 58 * MS),
    ]
    calls = [("blocked_window_gather_multi", 1_675_000_000),
             ("owner_recovery", 1_675_000_000),
             ("paged_window_gather", 3_350_000_000)]
    return Record(t0, t0 + 100 * MS, reqs, ev, calls, card)


def test_stage_readers():
    rec = _record()
    assert _reader("fused.dispatch_ms")(rec) == pytest.approx(5.0)
    assert _reader("fused.fetch_rounds")(rec) == pytest.approx(2.5)
    assert _reader("fetch.wait_ms")(rec) == pytest.approx(15.0)
    assert _reader("fetch.decode_ms")(rec) == pytest.approx(3.0)
    assert _reader("encode.ms")(rec) == pytest.approx(5.0)


def test_device_readers():
    rec = _record()
    # htod 2 ms + the page gather 1 ms, over two requests
    assert _reader("upload.device_ms")(rec) == pytest.approx(1.5)
    # the radix sort alone is neither a copy nor a hand kernel
    assert _reader("joins.torch_device_ms")(rec) == pytest.approx(1.5)
    # busy 9 ms + 2 ms of a 100 ms window
    assert _reader("device.idle_share")(rec) == pytest.approx(0.89)
    # least bytes 6.7 GB at 3.35 TB/s = 2 ms, over 3 ms of hand kernels
    assert _reader("hand_kernels_roofline")(rec) == pytest.approx(200.0 / 3)


def test_readers_with_nothing_to_read_return_none():
    rec = _record(card="a card not in the table")
    assert _reader("hand_kernels_roofline")(rec) is None
    empty = Record(0, 10 * MS, [Request("q", 0, MS, True)], [], [], "")
    for name in ("fused.dispatch_ms", "fused.fetch_rounds", "fetch.wait_ms",
                 "fetch.decode_ms", "encode.ms", "upload.device_ms",
                 "joins.torch_device_ms", "hand_kernels_roofline",
                 "device.idle_share"):
        assert _reader(name)(empty) is None, name


def test_every_declared_metric_has_a_reader():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for m in manifest["per_layer"]:
        assert callable(_reader(m["name"]))
    for m in manifest["end_to_end"]:
        assert callable(_reader(m["name"], "end_to_end"))


def test_end_to_end_readers():
    # 20 requests, one failed at 900 ms, over a 4 s window
    times = [float(t) for t in range(10, 200, 10)] + [900.0]
    window = Window(times_ms=times, window_s=4.0, setup_s=31.5,
                    peak_bytes=3 * 2 ** 30)

    def read(name):
        return _reader(name, "end_to_end")(window)

    assert read("setup_s") == 31.5
    assert read("queries_per_s") == pytest.approx(5.0)
    assert read("query_p50_ms") == 100.0  # nearest rank: the 10th of 20
    assert read("query_p95_ms") == 190.0  # the 19th: the failed one is 20th
    assert read("peak_device_gib") == pytest.approx(3.0)
    assert percentile([5.0], 95) == 5.0


def test_breakdown():
    out = breakdown(_record())
    assert out["device_ops"][0] == ["void at::native::radixSortKVInPlace(...)",
                                    pytest.approx(0.003)]
    # idle 0-1 ms (q1's dispatch), 10-56 ms (q1's dispatch 10-20, fetch
    # 20-25, decode 25-30, encode 30-40; between 40-50; q2's dispatch
    # 50-55, fetch 55-56) and 58-100 ms (q2's fetch 58-60, decode 60-70,
    # encode 70-90; between 90-100)
    assert dict(out["idle_gaps"]) == {
        "dispatch": pytest.approx(0.016), "fetch": pytest.approx(0.008),
        "decode": pytest.approx(0.015), "encode": pytest.approx(0.030),
        "between requests": pytest.approx(0.020)}
    assert out["idle_gaps"][0][0] == "encode"
