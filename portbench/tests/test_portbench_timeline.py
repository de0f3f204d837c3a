"""The engine's own device timeline, read by six metrics that are new
files and new entries only: each reader turns the counters' growth over
the window into ms per timed step, and leaves its metric out, without
raising, where the engine keeps no such counters (a checkout from
before them) or no timed step ran; in a traced run on the CPU they are
found by name; the untraced run reports the end-to-end metrics alone;
and no file that was there changes."""

from pathlib import Path

import pytest

from portbench import run, spec
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
# Each metric and the counter it divides by decode_timed_steps.
TIMELINE = {"attn_ms_per_step": "decode_attn_ns", "ffn_ms_per_step": "decode_ffn_ns",
            "moe_route_ms_per_step": "decode_moe_route_ns",
            "sampler_ms_per_step": "decode_head_ns",
            "decode_gap_ms_per_step": "decode_gap_ns",
            "placement_stall_ms_per_step": "decode_gap_placement_ns"}


def _run(counters: dict) -> run.Run:
    return run.Run({}, {}, [], 0.0, 1.0, 0.0, counters, 4)


@pytest.mark.parametrize("name", sorted(TIMELINE))
def test_each_reader_divides_its_counter_by_the_timed_steps(name):
    read = spec.reader(REPO, name)
    counter = TIMELINE[name]
    opened = {"decode_timed_steps": 10, counter: 5_000_000}
    assert read(_run({"open": opened,
                      "close": {"decode_timed_steps": 30, counter: 45_000_000}})) == 2.0
    # No timed step in the window, or an engine without the counters.
    assert read(_run({"open": opened, "close": dict(opened)})) is None
    assert read(_run({"open": {"decode_steps": 1}, "close": {"decode_steps": 9}})) is None


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_traced_runs_report_the_timeline_metrics_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _files(root)
    dense = spec.load_cell(root, "tiny.open")
    assert set(TIMELINE) - {"moe_route_ms_per_step"} <= {m["name"] for m in dense.per_layer}
    result = run.run_cell(dense, "tiny.open", 2**31 + 11, 1.5, True, "cpu", root=root)
    assert result["correct"], result["checked"]
    got = result["metrics"]
    for name in set(TIMELINE) - {"moe_route_ms_per_step"}:
        assert got[name]["unit"] == "ms", name
    for name in ("attn_ms_per_step", "ffn_ms_per_step", "sampler_ms_per_step",
                 "decode_gap_ms_per_step"):
        assert got[name]["value"] > 0, name
    assert 0 <= got["placement_stall_ms_per_step"]["value"] \
        <= got["decode_gap_ms_per_step"]["value"]

    moe = spec.load_cell(root, "tiny.closed")
    assert "moe_route_ms_per_step" in {m["name"] for m in moe.per_layer}
    got = run.run_cell(moe, "tiny.closed", 2**31 + 12, 1.5, True, "cpu", root=root)["metrics"]
    assert 0 < got["moe_route_ms_per_step"]["value"] < got["ffn_ms_per_step"]["value"]

    untraced = run.run_cell(dense, "tiny.open", 2**31 + 11, 1.5, False, "cpu", root=root)
    assert set(untraced["metrics"]) == {m["name"] for m in dense.end_to_end}
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
