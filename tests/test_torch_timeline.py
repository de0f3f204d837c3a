"""The decode step's device timeline (``omnia_tpu_torch/utils/timeline.py``)
on the CPU, where a stamp and a mark read the host's clock: each timed
step's regions in order and inside its chunk, the early-out's skipped
steps left out, the MoE's routing inside its FFN, the split by region
from a step's labels, and the Chrome export's device row. The card's
edition (stamp kernels in the captured IF bodies, event pairs against a
profiler trace) is ``tests/test_torch_timeline_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest

from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import flight
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.utils import timeline as tl

PROMPTS = [[1, 2, 3], [7] * 30, [5, 4], list(range(40, 60)), [8, 9, 10, 11]]


def _engine(name="test-tiny", **fields):
    fields = dict(dict(num_slots=8, max_seq=128, prefill_buckets=(16, 32), dtype="float32",
                       decode_ring=2, decode_chunk=8, decode_chunk_variants=(),
                       flight_events=4096), **fields)
    return InferenceEngine(get_config(name), EngineConfig(**fields), seed=0, device="cpu")


def _serve(eng, prompts=PROMPTS):
    hs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=5 + 4 * i))
          for i, p in enumerate(prompts)]
    while eng.step():
        pass
    return [h.collect_tokens(timeout=60)[0] for h in hs]


def _record_chunks(eng, monkeypatch) -> list:
    """Each resolved chunk's (step stamps [steps, n], labels, event-pair ns)."""
    seen = []
    resolve = eng._timeline.resolve

    def spy(timing, metrics):
        seen.append((timing.stamps.steps(timing.host_data()), list(timing.stamps.labels),
                     eng._timeline.between(timing.e0, timing.e1)))
        return resolve(timing, metrics)

    monkeypatch.setattr(eng._timeline, "resolve", spy)
    return seen


def test_ring_steps_stamp_their_regions_in_order_inside_the_chunk(monkeypatch):
    """A ring engine (decode_ring = 2, the eager ring on the CPU): each
    timed step's stamps come in order on the host clock, each region of
    every step is > 0, and the regions together stay within the chunk's
    own interval (Python outside the regions is a large share here, so
    no tighter bound); the counters are the chunks' sums."""
    eng = _engine()
    seen = _record_chunks(eng, monkeypatch)
    _serve(eng)
    m = eng.metrics
    assert seen and m["decode_timed_steps"] == sum(len(s) for s, _, _ in seen) > 0
    total = dict.fromkeys(tl.REGIONS, 0)
    for steps, labels, chunk_ns in seen:
        masks = tl.region_masks(labels)
        assert labels[0] == "attn" and labels[-2:] == ["head", "end"]
        assert labels.count("attn") == labels.count("ffn") == eng.model_cfg.num_layers
        split = 0
        for row in steps:
            assert (np.diff(row) > 0).all()
            spans = np.diff(row)
            for r in ("attn", "ffn", "head"):
                assert spans[masks[r]].sum() > 0, r
            split += sum(int(spans[masks[r]].sum()) for r in ("attn", "ffn", "head"))
            for r in tl.REGIONS:
                total[r] += int(spans[masks[r]].sum())
        assert split <= chunk_ns
    assert m["decode_attn_ns"] + m["decode_ffn_ns"] + m["decode_head_ns"] \
        <= m["decode_chunk_device_ns"]
    for r in tl.COUNTED:
        assert m[f"decode_{r}_ns"] == total[r], r
    assert m["decode_moe_route_ns"] == 0
    assert 0 < m["decode_gap_placement_ns"] <= m["decode_gap_ns"]


def test_early_out_counts_only_the_steps_that_ran():
    """Chunks of 8 overshoot the answers' ends, so the ring skips their
    tails: the timed steps are the decode steps less the early exits,
    and each chunk's flight event carries the steps that ran."""
    eng = _engine()
    _serve(eng)
    m = eng.metrics
    assert m["early_exit_steps"] > 0
    assert m["decode_timed_steps"] == m["decode_steps"] - m["early_exit_steps"]
    chunks = eng._flight.events("decode_chunk")
    assert sum(e.attrs["steps_ran"] for e in chunks) == m["decode_timed_steps"]
    assert any(e.attrs["steps_ran"] < e.attrs["chunk"] for e in chunks)
    for e in chunks:
        assert e.attrs["dev_t0_ns"] < e.attrs["dev_t1_ns"]


def test_moe_routing_is_inside_its_ffn(monkeypatch):
    """On the MoE test-tiny config the expert products are stamped
    inside each layer's FFN: 0 < moe_route < ffn, and route + experts
    make up the MoE layers' FFN."""
    eng = _engine("test-tiny-moe")
    seen = _record_chunks(eng, monkeypatch)
    _serve(eng)
    m = eng.metrics
    assert 0 < m["decode_moe_route_ns"] < m["decode_ffn_ns"]
    labels = seen[0][1]
    assert labels.count("experts") == labels.count("route") == eng.model_cfg.num_layers
    split = [e.attrs for e in eng._flight.events("decode_chunk")]
    assert sum(a["moe_route_ns"] + a["experts_ns"] for a in split) == m["decode_ffn_ns"]


@pytest.mark.parametrize("labels,want", [
    (["attn", "ffn", "attn", "ffn", "head", "end"],
     {"attn": [1, 0, 1, 0, 0], "ffn": [0, 1, 0, 1, 0], "experts": [0] * 5,
      "moe_route": [0] * 5, "head": [0, 0, 0, 0, 1]}),
    (["attn", "ffn", "experts", "route", "attn", "ffn", "head", "end"],
     {"attn": [1, 0, 0, 0, 1, 0, 0], "ffn": [0, 1, 1, 1, 0, 1, 0],
      "experts": [0, 0, 1, 0, 0, 0, 0], "moe_route": [0, 1, 0, 1, 0, 0, 0],
      "head": [0, 0, 0, 0, 0, 0, 1]}),
])
def test_region_masks_from_a_steps_labels(labels, want):
    """A layer's FFN is a MoE layer's when it holds the experts: its
    other intervals are the routing; a dense layer's FFN routes nothing."""
    got = tl.region_masks(labels)
    assert {r: m.astype(int).tolist() for r, m in got.items()} == want


def test_stamps_refuse_an_overflow_and_a_step_unlike_the_first():
    import torch

    s = tl.Stamps(2, 3, torch.device("cpu"))
    for label in ("attn", "head", "end"):
        s.stamp(label)
    with pytest.raises(RuntimeError, match="step 1 stamps"):
        s.stamp("ffn")
    s = tl.Stamps(1, 2, torch.device("cpu"))
    s.stamp("attn")
    s.stamp("end")
    with pytest.raises(RuntimeError, match="overflow"):
        s.stamp("attn")


def test_chrome_export_draws_device_intervals_on_their_own_row():
    """Events with a device interval are drawn again on the "device"
    row, moved onto the host rows' base: a piece whose device interval
    is its host dispatch lands where its host slice is; a decode chunk's
    region split rides its args. A dump without them has no such row."""
    ticks = iter(np.arange(100.0, 200.0, 0.5))
    rec = flight.FlightRecorder(64, clock=lambda: float(next(ticks)))
    rec.note_submit("r1", 5)
    rec.note_claim("r1")
    piece = rec.note_prefill_piece("r1", 5, 8, 0.25)
    wall = piece.ts - piece.mono        # the recorder's wall - mono offset
    t0 = round((piece.mono - 0.25 + wall) * 1e9)
    rec.note_device_interval(piece, t0, t0 + 250_000_000)
    regions = {"attn_ns": 40, "ffn_ns": 30, "experts_ns": 0, "moe_route_ns": 0, "head_ns": 10}
    rec.note_decode_chunk(2, 0.01, 0.02, 1,
                          timeline=dict(dev_t0_ns=t0 + 600_000_000, dev_t1_ns=t0 + 700_000_000,
                                        steps_ran=2, **regions))
    plain = flight.to_chrome_trace(rec.events()[:2])
    assert all(e.get("tid") != flight.DEVICE_TID for e in plain["traceEvents"])
    doc = flight.to_chrome_trace(rec.events())["traceEvents"]
    names = [e for e in doc if e.get("tid") == flight.DEVICE_TID and e["ph"] == "M"]
    assert {"name": "device"} in [e["args"] for e in names]
    dev = {e["name"]: e for e in doc if e.get("tid") == flight.DEVICE_TID and e["ph"] == "X"}
    host = {e["name"]: e for e in doc if e.get("tid") == 0 and e["ph"] == "X"}
    assert dev["prefill_piece"]["ts"] == pytest.approx(host["prefill_piece"]["ts"], abs=2)
    assert dev["prefill_piece"]["dur"] == pytest.approx(250_000.0, abs=2)
    assert dev["decode_chunk"]["ts"] - dev["prefill_piece"]["ts"] == pytest.approx(600_000,
                                                                                   abs=2)
    assert dev["decode_chunk"]["args"]["steps_ran"] == 2
    assert dev["decode_chunk"]["args"]["attn_ns"] == 40
    assert "dev_t0_ns" not in dev["decode_chunk"]["args"]
    assert piece.attrs["dev_t1_ns"] - piece.attrs["dev_t0_ns"] == 250_000_000
