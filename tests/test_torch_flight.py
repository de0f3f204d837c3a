"""The port's flight recorder held against the JAX package on the CPU.

The recorder copy (``omnia_tpu_torch/engine/flight.py``) and the JAX
recorder, driven through one script of every seam on one scripted clock,
give equal events (their wall ``ts`` aside, which derives from each
recorder's construction time), breakdowns, histograms, spans, stats,
jsonl dumps and Chrome exports. The port engine with ``flight_events`` on
and the JAX engine, stepped inline over one scripted workload (a burst,
a session of three turns, an interleaved arrival beside live decoders,
prompt-lookup speculation and a grammared request) on each of the four
KV caches, record the same event kinds with the same time-free
attributes per request and on the engine's step row; the ledger equals
the engine's books and each breakdown tiles its request's wall."""

from __future__ import annotations

import itertools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine import flight as jflight
from omnia_tpu.engine.grammar import compile_json_schema as jcompile_json_schema
from omnia_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.utils import metrics as jmetrics
from omnia_tpu.utils import tracing as tr
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import flight as tflight
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.utils import metrics as tmetrics
from omnia_tpu_torch.utils import timeline

# Engine fields of the workload: 4 slots, so the burst leaves decoders
# live when the interleaved arrival lands; pieces of 4 tokens; a verify
# window of 2; grammars of up to 128 states.
BASE = dict(num_slots=4, max_seq=128, prefill_buckets=(16, 32), dtype="float32",
            decode_chunk=4, max_sessions=4, prefill_chunk_tokens=4, spec_decode=2,
            grammar=True, grammar_max_states=128, flight_events=2048)
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=33, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=33, kv_page_tokens=16),
}
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8, 5, 6]   # prompt lookup accepts here
PROMPT_S = list(range(40, 70))                             # 30 tokens: 8 pieces
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}
STOP = (0,)   # byte 0 is never admissible in the grammar: it plays EOS
# Kinds the JAX engine records that this workload cannot reach in the
# port: the decode ring's drains (the workload runs with the ring off).
JAX_ONLY_KINDS = {"ring_drain"}
# Attributes that are times (or carry them); everything else must match.
TIMED = {"dispatch_s", "sync_s", "prefill_s", "seconds"}
# The port's device timeline on decode chunks and prefill pieces
# (utils/timeline.py), which the JAX engine does not keep.
DEVICE_TIMELINE = {"dev_t0_ns", "dev_t1_ns", "steps_ran"} | {f"{r}_ns" for r in timeline.REGIONS}
# The stages tile the wall within 5%, plus 20 ms for the host's
# bookkeeping between stage boundaries (the JAX package's own bound).
TILE_REL, TILE_ABS = 0.05, 0.02


# ---------------------------------------------------------------------------
# The recorder copy
# ---------------------------------------------------------------------------


def test_vocabulary_and_span_name_equal_jax():
    assert tflight.EVENTS == jflight.EVENTS
    assert tflight.INIT_EVENTS == jflight.INIT_EVENTS
    assert tflight.SPAN_ENGINE == tr.SPAN_ENGINE


@pytest.mark.parametrize("buckets", [None, (1, 10, 100)])
def test_histogram_equals_jax(buckets):
    kw = {} if buckets is None else {"buckets": buckets}
    j, t = jmetrics.Histogram("h", **kw), tmetrics.Histogram("h", **kw)
    for v in np.random.default_rng(0).exponential(2.0, 300):
        j.observe(float(v))
        t.observe(float(v))
    assert t.expose() == j.expose() and t.count == j.count == 300
    assert [t.quantile(q) for q in (0, 0.5, 0.9, 0.99, 1)] == \
        [j.quantile(q) for q in (0, 0.5, 0.9, 0.99, 1)]


def _script(rec, tracer, ctx: str) -> None:
    """Every seam of the recorder once or more, in a fixed order."""
    rec.note_init_phase("backend_init", {"backend": "cpu", "seconds": 0.5})
    rec.note_init_phase("weights_load", {"seconds": 2.0, "bytes": 100})
    rec.note_submit("r1", 5, ctx, tracer)
    rec.note_submit("r2", 9)
    rec.note_claim("r1")
    rec.note_prefill_piece("r1", 5, 8, 0.01)
    rec.note_stall(2)
    rec.note_placement("r1", 0, 5, reuse=1, seeded=2, prefill_s=0.2, stalled=True)
    rec.note_grammar_attach("r1", 17)
    rec.note_claim("r2")
    rec.note_mixed_step("r2", 4, 4, 0.03)
    rec.note_decode_chunk(4, 0.002, 0.001, 2)
    rec.note_decode_chunk(1, 0.002, 0.004, 1, drained=True)
    rec.note_ring_drain(1, 8, 0.003)
    rec.note_spec_verify(6, 4, 0.01, 0.02, 2)
    rec.note_offload("s1", 64)
    rec.note_restore("s1", 3)
    rec.note_failover("r2", 1)
    rec.note_resubmit("r2", 0, reason="retirement")
    rec.note_shed("saturated")
    rec.note_migrate("s1", 0, 1, fallback=True)
    rec.note_handoff("s1", 0, 1, export_s=0.1, import_s=0.2)
    rec.note_drain(0, 1.5)
    rec.note_placement("r2", 1, 9)
    rec.note_terminal("r1", "stop", tokens=7, first_token_at=rec._clock())
    rec.note_terminal("r2", "error", tokens=1, error="boom", first_token_at=rec._clock())
    rec.note_submit("r3", 3)
    rec.note_terminal("r3", "deadline")          # never claimed: all queue
    rec.note_terminal("ghost", "cancelled")      # no submit: tolerated
    rec.note_init_phase("warmup_compile", {"seconds": 1.0, "programs": 3})


def _scripted(module, capacity: int):
    """A recorder of ``module`` on a clock that steps 0.125 s a call, run
    through the script with a tracer of its own."""
    ticks = itertools.count(100.0, 0.125)
    rec = module.FlightRecorder(capacity, clock=lambda: next(ticks))
    tracer = tr.Tracer("flight-test")
    root = tr.Tracer("caller").start_span("llm")
    _script(rec, tracer, root.traceparent())
    return rec, tracer, root


def _without_ts(events) -> list:
    out = []
    for e in events:
        d = e.to_dict()
        d.pop("ts")
        out.append(d)
    return out


@pytest.mark.parametrize("capacity", [4096, 16])
def test_recorder_equals_jax_on_a_scripted_clock(capacity, tmp_path, capsys):
    """Events, breakdowns, stats, histograms, spans and the Chrome export
    equal the JAX recorder's; at capacity 16 the ring drops the same
    events. The dumps convert through either CLI to the same trace."""
    j, jtracer, jroot = _scripted(jflight, capacity)
    t, ttracer, troot = _scripted(tflight, capacity)
    assert _without_ts(t.events()) == _without_ts(j.events())
    assert t.stats() == j.stats()
    assert t.stats()["dropped"] == (0 if capacity > 100 else t.stats()["recorded"] - 16)
    for name, h in j.hist.items():
        assert t.hist[name].expose() == h.expose()
    assert tflight.to_chrome_trace(t.events()) == jflight.to_chrome_trace(j.events())
    # The engine span: the same name, attributes and parentage.
    (js,), (ts,) = jtracer.spans(tr.SPAN_ENGINE), ttracer.spans(tr.SPAN_ENGINE)
    assert ts.attrs == js.attrs and ts.attrs["engine.tokens"] == 7
    assert (ts.trace_id, ts.parent_id) == (troot.trace_id, troot.span_id)
    # jsonl dump → either CLI → the same Chrome trace.
    traces = []
    for mod, rec in ((tflight, t), (jflight, j)):
        dump = tmp_path / f"{mod.__name__}.jsonl"
        assert rec.dump_jsonl(str(dump)) == len(rec.events())
        out = tmp_path / f"{mod.__name__}.json"
        assert mod.main([str(dump), "-o", str(out)]) == 0
        traces.append(json.loads(out.read_text()))
    assert traces[0] == traces[1]
    assert "terminals" in capsys.readouterr().out
    jroot.end()
    troot.end()


def test_recorder_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tflight.FlightRecorder(0)
    rec = tflight.FlightRecorder(8)
    with pytest.raises(AssertionError):
        rec.note_init_phase("submit")
    assert tflight.to_chrome_trace([]) == jflight.to_chrome_trace([]) == {"traceEvents": []}


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def grammar():
    return jcompile_json_schema(SCHEMA, JByteTokenizer())


def _drain(engine):
    while engine.step():
        pass


def _workload(engine, sp_cls, grammar) -> dict:
    """Three greedy requests at once (one repetitive, so that speculation
    verifies), a session's first turn arriving while they decode (it
    interleaves), its second and third turns, then a grammared request.
    Returns each request's tokens, keyed by label."""
    g = dict(temperature=0.0)
    hs = {
        "b0": engine.submit([1, 2, 3, 4, 5], sp_cls(max_tokens=20, **g)),
        "b1": engine.submit(REPETITIVE, sp_cls(max_tokens=24, **g)),
        "b2": engine.submit(list(range(20, 41)), sp_cls(max_tokens=16, **g)),
    }
    for _ in range(4):
        engine.step()
    hs["s1"] = engine.submit(PROMPT_S, sp_cls(max_tokens=6, **g), session_id="s")
    _drain(engine)
    out = {k: h.collect_tokens(timeout=30)[0] for k, h in hs.items()}
    prompt = PROMPT_S
    for turn in ("s2", "s3"):
        prompt = prompt + out["s1" if turn == "s2" else "s2"] + [7, 8, 9]
        h = engine.submit(prompt, sp_cls(max_tokens=5, **g), session_id="s")
        _drain(engine)
        out[turn] = h.collect_tokens(timeout=30)[0]
    h = engine.submit([10, 11, 12], sp_cls(max_tokens=24, stop_token_ids=STOP, **g),
                      grammar=grammar)
    _drain(engine)
    out["g"] = h.collect_tokens(timeout=30)[0]
    return out


def _time_free(attrs: dict) -> dict:
    out = {k: v for k, v in attrs.items() if k not in TIMED | DEVICE_TIMELINE}
    if "breakdown" in out:
        bd = out.pop("breakdown")
        out["tokens"], out["stall_steps"] = bd["tokens"], bd["stall_steps"]
    return out


def _ledger(engine) -> tuple[dict, list]:
    """Per request, its (kind, time-free attributes) in order; and the
    engine step row's."""
    per_req: dict = {}
    steps = []
    for e in engine._flight.events():
        if e.kind in tflight.INIT_EVENTS:
            continue
        row = (e.kind, _time_free(e.attrs))
        if e.request_id:
            per_req.setdefault(e.request_id, []).append(row)
        else:
            steps.append(row)
    return per_req, steps


@pytest.fixture(scope="module", params=list(KV_CONFIGS))
def runs(request, jparams, tparams, grammar):
    fields = dict(BASE, **KV_CONFIGS[request.param])
    jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields), params=jparams, seed=0)
    teng = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields), params=tparams,
                           seed=0, device="cpu")
    return (jeng, _workload(jeng, JSamplingParams, grammar),
            teng, _workload(teng, SamplingParams, grammar))


def test_engine_events_equal_jax(runs):
    """Same tokens; per request the same event kinds with the same slot,
    n_prompt, reuse, seeded, take, bucket, reason and tokens; on the step
    row the same decode chunks (size, active slots), verify steps
    (proposed, accepted), offloads and restores. The workload reaches
    every engine seam but the decode ring's."""
    jeng, jout, teng, tout = runs
    assert tout == jout
    jreq, jsteps = _ledger(jeng)
    treq, tsteps = _ledger(teng)
    assert treq == jreq
    assert tsteps == jsteps
    kinds = {e.kind for e in teng._flight.events()}
    assert {"submit", "claim", "placement", "prefill_piece", "mixed_step", "decode_chunk",
            "spec_verify", "grammar_attach", "terminal", "backend_init"} <= kinds
    assert kinds <= tflight.EVENTS - JAX_ONLY_KINDS
    assert any(a["proposed"] and a["accepted"] for k, a in tsteps if k == "spec_verify")
    assert any(a["reuse"] for rows in treq.values() for k, a in rows if k == "placement")


def test_engine_ledger_is_exact_and_tiles_the_wall(runs):
    """Submit events equal requests_submitted, terminals requests_finished,
    no request is left open, and every request's queue + placement +
    decode equals its wall (submit to terminal) within TILE_REL + TILE_ABS."""
    _, _, teng, _ = runs
    rec, m = teng._flight, teng.metrics
    assert len(rec.events("submit")) == m["requests_submitted"] == 7
    assert len(rec.events("terminal")) == m["requests_finished"] == 7
    assert rec.stats()["open_requests"] == 0 and rec.stats()["dropped"] == 0
    sub = {e.request_id: e.mono for e in rec.events("submit")}
    for e in rec.events("terminal"):
        bd = e.attrs["breakdown"]
        wall = e.mono - sub[e.request_id]
        staged = bd["queue_s"] + bd["placement_s"] + bd["decode_s"]
        assert abs(staged - wall) <= TILE_REL * wall + TILE_ABS, (bd, wall)
        assert 0 < bd["ttft_s"] <= wall
    assert rec.hist["dispatch_us"].count > 0 and rec.hist["ttft"].count == 7
    doc = tflight.to_chrome_trace(rec.events())
    assert {"queue", "placement", "decode", "decode_chunk", "mixed_step"} <= \
        {ev["name"] for ev in doc["traceEvents"]}


def test_engine_span_joins_the_callers_trace(tparams):
    """A submit with a trace_ctx opens the engine's request span in the
    tracer the runtime sets, under the caller's span, with the breakdown
    stamped on."""
    eng = InferenceEngine(get_config("test-tiny"),
                          EngineConfig(num_slots=2, max_seq=64, prefill_buckets=(8,),
                                       dtype="float32", flight_events=64),
                          params=tparams, seed=0, device="cpu")
    tracer = tr.Tracer("port-engine")
    eng.tracer = tracer
    root = tr.Tracer("runtime").start_span("llm")
    h = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=8),
                   trace_ctx=root.traceparent())
    _drain(eng)
    toks, _ = h.collect_tokens(timeout=30)
    (span,) = tracer.spans(tr.SPAN_ENGINE)
    assert (span.trace_id, span.parent_id) == (root.trace_id, root.span_id)
    assert span.attrs["engine.tokens"] == len(toks) == 8
    assert span.attrs["llm.finish_reason"] == "length"
    root.end()


def test_flight_off_is_a_true_noop(tparams, monkeypatch):
    """flight_events=0: no recorder, flight_enabled 0, no thread, the
    same greedy tokens as a recorder-on engine, and a trace_ctx is taken
    and opens no span. No device timeline either: no stamp is made, no
    timing event, and every timeline counter stays 0, where the
    recorder-on engine's count its decode steps."""
    fields = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16), dtype="float32")
    made = []
    stamp, mark = timeline.Stamps.stamp, timeline.Timeline.mark
    monkeypatch.setattr(timeline.Stamps, "stamp",
                        lambda self, label: made.append(label) or stamp(self, label))
    monkeypatch.setattr(timeline.Timeline, "mark", lambda self: made.append("mark") or mark(self))
    threads = set(threading.enumerate())
    off = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields), params=tparams,
                          seed=0, device="cpu")
    on = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields, flight_events=64),
                         params=tparams, seed=0, device="cpu")
    assert off._flight is None and off.metrics["flight_enabled"] == 0
    assert on.metrics["flight_enabled"] == 1
    tracer = tr.Tracer("off")
    off.tracer = tracer
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    built = len(made)      # the recorder-on engine's anchor
    h = off.submit([4, 5, 6], sp, trace_ctx=tr.Tracer("up").start_span("llm").traceparent())
    _drain(off)
    assert off._timeline is None and len(made) == built
    assert all(off.metrics[k] == 0 for k in timeline.TIMELINE_KEYS)
    assert h.collect_tokens(timeout=30)[0] == on.generate([4, 5, 6], sp)[0]
    assert len(made) > built and on.metrics["decode_timed_steps"] == on.metrics["decode_steps"] > 0
    assert tracer.spans(tr.SPAN_ENGINE) == []
    assert set(threading.enumerate()) == threads
