"""The port's device-time harness (radixjoin_tpu_torch/harness/devtime.py)
and hardware model on the CPU: every case builds and runs one step at a
small size, the slope and single-call timers run, ``hardware.detect()``
gives the CPU entry, and the measurement entry points refuse to run
without a card. Device times themselves come only from the card."""

import math

import pytest
import torch

from radixjoin_tpu_torch import hardware
from radixjoin_tpu_torch.harness import devtime
from radixjoin_tpu_torch.tools import expt_gather2, expt_pallas, \
    expt_primitives

N = 1 << 12


@pytest.mark.parametrize("name", list(devtime.CASES))
def test_case_builds_and_runs_one_step(name):
    step, carry, rows, min_bytes = devtime.CASES[name](N, "cpu")
    assert rows >= N and min_bytes > 0
    out = step(carry)
    assert [(x.shape, x.dtype) for x in out] == [
        (x.shape, x.dtype) for x in carry]
    # the carry chains: a second step runs on the first one's outputs
    step(out)


def test_detect_gives_the_cpu_entry():
    assert hardware.detect("cpu") is hardware.CHIPS["cpu"]
    if not torch.cuda.is_available():
        assert hardware.detect() is hardware.CHIPS["cpu"]


def test_catalog_matches_h100_names():
    assert hardware._catalog_entry("NVIDIA H100 80GB HBM3").name == "h100_sxm"
    assert hardware._catalog_entry("NVIDIA H100 PCIe") is None
    assert hardware._catalog_entry("NVIDIA H100 NVL") is None
    assert hardware._catalog_entry("NVIDIA A100-SXM4-80GB") is None


def test_run_measures_on_the_host_clock_on_cpu():
    out = devtime.run(N, reps=1, cases=["copy", "join_merge_e2e"],
                      device="cpu", k_lo=1, k_hi=2)
    assert [m.kernel for m in out] == ["copy", "join_merge_e2e"]
    for m in out:
        assert m.mode == "host" and math.isfinite(m.device_ms)
        assert m.pct_roofline == pytest.approx(
            m.eff_gbps / hardware.CHIPS["cpu"].hbm_gbps)


def test_single_time_and_floor_on_cpu():
    step, carry, _rows, _b = devtime.CASES["cummax"](N, "cpu")
    floor = devtime.measure_floor_ms(reps=3, device="cpu")
    ms, reliable = devtime.single_time_ms(step, carry, reps=3,
                                          floor_ms=floor)
    assert floor >= 0 and ms > 0 and isinstance(reliable, bool)


def test_tool_mains_return_their_failed_cases(monkeypatch):
    """A tool case that raises is printed as FAILED, the others still run,
    and main() returns the failed names (the smoke fails on any)."""
    for mod in (expt_pallas, expt_primitives, expt_gather2):
        monkeypatch.setattr(mod, "require_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "cpu")
    assert expt_pallas.main(["--size", str(N), "--window", "4096",
                             "--cases", "nope,pallas_take"]) == ["nope"]
    assert expt_primitives.main(["--size", str(N), "--window", "4096",
                                 "--cases", "gather_1d,nope"]) == ["nope"]
    monkeypatch.setattr(expt_gather2, "RUNS", [
        ("g_lanes", expt_gather2.build_lanes, 1 << 10),
        ("g_bad", expt_gather2.build_lanes, 100)])  # not an (8, 128) table
    assert expt_gather2.main(N) == ["g_bad"]


def test_measurement_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would measure it")
    with pytest.raises(SystemExit):
        devtime.main(["--size", str(N), "--cases", "copy"])
    with pytest.raises(SystemExit):
        expt_pallas.main(["--size", str(N), "--cases", "cumsum"])
    with pytest.raises(SystemExit):
        expt_primitives.main(["--size", str(N), "--cases", "gather_1d"])
    with pytest.raises(SystemExit):
        expt_gather2.main(N)
