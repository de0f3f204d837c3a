"""The port's device-resident decode loop (``decode_ring``) held against
the JAX package on the CPU (``test-tiny``, f32, the same converted params).

The host classes (``validate_decode_ring``, ``RingGate``,
``DevLoopState``, the drainer) against the JAX copies on the same inputs
and tick sequences. Then the engine: with ``decode_ring=0`` nothing of
the ring exists and the decode programs are the ones the port always
had; with ``decode_ring=2`` the port's ring engine gives the JAX ring
engine's tokens, finish reasons, partial counts and ring books
(``ring_drains``, ``early_exit_steps``, ``ring_full_stalls``,
``deadline_exceeded``) on the four caches, beside speculation and
interleaving, under a grammar whose EOS only the per-slot grammar EOS
stops in-scan, with a mid-scan deadline, a cancel, a watchdog trip and
its recovery, a stop with chunks in flight, a full ring, and on an MoE
model; and its sessions' valid KV rows are the JAX engine's within 1e-6
(int8 rows within one quantization step). Runs stay under the self-gate's
32-chunk probe window, so that no wall-clock decision enters the books.
On the CPU the ring chunk is the eager edition; the captured one is held
against it on the card (``tests/test_torch_kernels_cuda.py``)."""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine import devloop as jdevloop
from omnia_tpu.engine import faults as jfaults
from omnia_tpu.engine.grammar import compile_json_schema as jcompile_json_schema
from omnia_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import devloop as tdevloop
from omnia_tpu_torch.engine import faults as tfaults
from omnia_tpu_torch.engine.scheduler import _InflightChunk
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine

BASE = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16), dtype="float32",
            max_sessions=0)
# 9 pages of 16 rows: both slots' 64 rows and the trash page.
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=9, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=9, kv_page_tokens=16),
}
RING_BOOKS = ("ring_drains", "early_exit_steps", "ring_full_stalls", "deadline_exceeded",
              "decode_steps", "tokens_generated", "requests_finished", "decode_ring_enabled",
              "decode_ring_gate_state")
RING_KEYS = ("decode_ring_enabled", "ring_drains", "ring_full_stalls", "early_exit_steps",
             "decode_ring_gate_state")
# f32 rows: equal ops in another framework round within this; int8 rows:
# a value within rounding of a .5 step may quantize to the neighbour.
KV_ATOL = 1e-6
WATCHDOG_S, HANG_S = 0.3, 1.5


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _engine(port: bool, params, model: str = "test-tiny", model_kw=None, **fields):
    f = dict(BASE, **fields)
    if port:
        return InferenceEngine(get_config(model, **(model_kw or {})), EngineConfig(**f),
                               params=params, seed=0, device="cpu")
    return JEngine(jget_config(model, **(model_kw or {})), JEngineConfig(**f), params=params,
                   seed=0)


def _pair(jparams, tparams, **kw):
    return _engine(False, jparams, **kw), _engine(True, tparams, **kw)


def _sp(engine, **kw):
    cls = SamplingParams if isinstance(engine, InferenceEngine) else JSamplingParams
    return cls(**kw)


def _drain(engine):
    while engine.step():
        pass


def _record(handle) -> tuple:
    toks, fin = handle.collect_tokens(timeout=30)
    return toks, fin.finish_reason.value, fin.num_prompt_tokens, fin.num_generated_tokens


def _books(engine) -> dict:
    return {k: engine.metrics[k] for k in RING_BOOKS}


def _leaves(kv) -> list:
    if hasattr(kv, "q"):
        return [np.asarray(kv.q), np.asarray(kv.s)]
    return [np.asarray(kv)]


def _session_rows(engine, sid) -> list:
    """The session's valid rows (the ring may skip frozen-slot writes, so
    only rows below the session's frontier compare), in the cache's
    representation."""
    sess = engine._sessions[sid]
    k, v = engine._offload_fn(engine._ck, engine._cv, sess.slot, len(sess.token_ids))
    return _leaves(k) + _leaves(v)


def _assert_rows_close(got: list, want: list):
    for x, y in zip(got, want, strict=True):
        assert x.shape == y.shape
        if x.dtype == np.int8:
            assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(x, y, atol=KV_ATOL, rtol=1e-6)


# ---------------------------------------------------------------------------
# The host classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [-1, 0, 1, 2, 3, 8, None])
def test_validate_decode_ring_equal_jax(ring):
    """0 is off, 1 and negatives raise with the JAX messages, >= 2 is a
    ring, and a config without the field is off."""
    cfg = SimpleNamespace() if ring is None else SimpleNamespace(decode_ring=ring)
    outcomes = []
    for fn in (jdevloop.validate_decode_ring, tdevloop.validate_decode_ring):
        try:
            fn(cfg)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (ring is None or ring == 0 or ring >= 2)


@pytest.mark.parametrize("seed", range(4))
def test_ring_gate_equal_jax(seed):
    """Both gates fed one seeded tick sequence (irregular clocks, token
    counts, both arms winning in turn) agree at every tick."""
    rng = np.random.default_rng(seed)
    window, hold = int(rng.integers(0, 4)), int(rng.integers(1, 4))
    j, t = jdevloop.RingGate(window, hold_factor=hold), tdevloop.RingGate(window,
                                                                          hold_factor=hold)
    now, tokens = 0.0, 0
    for _ in range(80):
        now += float(rng.choice([0.0, rng.uniform(0.01, 2.0)]))
        tokens += int(rng.integers(0, 50))
        assert t.tick(now, tokens) == j.tick(now, tokens)
        assert (t.state, t.state_code(), t.allows_async(), t.decisions, t.disables) == (
            j.state, j.state_code(), j.allows_async(), j.decisions, j.disables)
        assert t.report() == j.report()


@pytest.mark.parametrize("ring", [0, 2, 3])
def test_devloop_state_equal_jax(ring):
    """Capacity, the gate, whether a dispatch drains async on the wall and
    an injected clock (with the gate holding off too), and the step-time
    EMA over one sequence of chunk times."""
    j, t = jdevloop.DevLoopState(ring), tdevloop.DevLoopState(ring)
    try:
        assert (t.ring, t.capacity, t.gate is None) == (j.ring, j.capacity, j.gate is None)
        for wall in (True, False):
            assert t.async_engaged(wall) == j.async_engaged(wall)
        if ring:
            t.gate.state = j.gate.state = jdevloop.RingGate.HOLD_OFF
            for wall in (True, False):
                assert t.async_engaged(wall) == j.async_engaged(wall)
        for x in np.random.default_rng(ring).uniform(1e-3, 0.1, 20):
            j.observe_step_time(float(x))
            t.observe_step_time(float(x))
            assert t.step_ema_s == j.step_ema_s
        gateless = tdevloop.DevLoopState(2, gate=False)
        assert gateless.gate is None and gateless.async_engaged(True)
    finally:
        j.stop()
        t.stop()


def test_drainer_lazy_poison_callback_and_stats():
    """Nothing until first use; a poisoned drainer is replaced; the
    callback runs on the drainer thread with the host array and the
    read's seconds (an injected sleep included), a failing callback
    leaves the drainer serving, and the stats count every read."""
    st = tdevloop.DevLoopState(2)
    assert st.drainer_if_live() is None
    d = st.get_drainer()
    assert st.get_drainer() is d
    seen, fired = {}, threading.Event()

    def cb(arr, took):
        seen.update(arr=arr, took=took, thread=threading.current_thread().name)
        fired.set()

    out = d.wait(d.submit(lambda: np.arange(3), pre_sleep_s=0.05, on_drained=cb), timeout=5)
    assert out.tolist() == [0, 1, 2] and fired.wait(5)
    assert seen["arr"].tolist() == [0, 1, 2] and seen["took"] >= 0.05
    assert seen["thread"] == "omnia-chunk-drainer"
    d.wait(d.submit(lambda: np.ones(1), on_drained=lambda a, s: 1 / 0), timeout=5)
    assert d.wait(d.submit(lambda: np.zeros(2)), timeout=5).tolist() == [0, 0]
    drains, drain_s = d.stats()
    assert drains == 3 and drain_s >= 0.05
    d.poisoned = True
    assert st.drainer_if_live() is None
    fresh = st.get_drainer()
    assert fresh is not d and not fresh.poisoned
    st.stop()
    assert st._drainer is None


def test_inflight_chunk_fields():
    import torch

    toks = torch.zeros((2, 3), dtype=torch.int32)
    ch = _InflightChunk(toks, [(0, "r0")], 0.25)
    assert ch.dl_steps is None and ch.entry is None
    assert ch.dispatch_s == 0.25 and ch.read().shape == (2, 3)
    assert not hasattr(ch, "__dict__")


# ---------------------------------------------------------------------------
# The engine: ring off
# ---------------------------------------------------------------------------


def test_decode_ring_off_is_true_noop(jparams, tparams):
    """decode_ring=0 builds nothing of the ring: no devloop container
    without a watchdog, no per-slot grammar EOS, no graphs, the decode
    programs the port always had, every ring metric 0, and the JAX
    engine's tokens. A watchdog engine owns the drainer's container at
    ring 0, with no capacity and no gate."""
    jeng, teng = _pair(jparams, tparams, grammar=True, grammar_max_states=64)
    wd = _engine(True, tparams, watchdog_s=30.0)
    assert teng._devloop is None and teng._geos is None and teng._ring_graphs is None
    assert all(fn.__name__ == f"decode_chunk_{k}" for k, fn in teng._decode_fns.items())
    assert wd._devloop.ring == 0 and wd._devloop.capacity == 0 and wd._devloop.gate is None
    for eng in (jeng, teng, wd):
        h = eng.submit([1, 2, 3], _sp(eng, temperature=0.0, max_tokens=12))
        _drain(eng)
        eng.toks = _record(h)
        for key in RING_KEYS:
            assert eng.metrics[key] == 0, key
    assert teng.toks == jeng.toks == wd.toks
    wd.stop()


def test_ring_one_rejected_as_in_jax(tparams):
    with pytest.raises(ValueError, match="one-deep ring"):
        _engine(True, tparams, decode_ring=1)


# ---------------------------------------------------------------------------
# The engine: ring on, against the JAX ring engine
# ---------------------------------------------------------------------------


def _session_script(engine) -> dict:
    """Two greedy sessions sharing the batch (one finishes early, so the
    other's chunks carry a finished slot), then a second turn of the
    first, which reuses its rows; a sampled, seeded request at the end."""
    g = dict(temperature=0.0)
    hs = {"a": engine.submit([1, 2, 3, 4], _sp(engine, max_tokens=12, **g), session_id="a"),
          "b": engine.submit([9, 8, 7], _sp(engine, max_tokens=5, **g), session_id="b")}
    _drain(engine)
    out = {k: _record(h) for k, h in hs.items()}
    h2 = engine.submit([1, 2, 3, 4] + out["a"][0] + [5, 6],
                       _sp(engine, max_tokens=9, **g), session_id="a")
    h3 = engine.submit([3, 1, 4, 1, 5], _sp(engine, max_tokens=7, temperature=0.8, seed=11))
    _drain(engine)
    out.update(a2=_record(h2), s=_record(h3)[1:])   # sampled bits differ across packages
    return out


@pytest.mark.parametrize("cache", list(KV_CONFIGS))
def test_ring_equal_jax_on_each_cache(jparams, tparams, cache):
    fields = dict(KV_CONFIGS[cache], decode_ring=2, max_sessions=4)
    jeng, teng = _pair(jparams, tparams, **fields)
    assert teng._devloop.ring == 2 and teng._devloop.capacity == 2
    jout, tout = _session_script(jeng), _session_script(teng)
    assert tout == jout
    assert _books(teng) == _books(jeng)
    assert teng.metrics["ring_drains"] > 0 and teng.metrics["early_exit_steps"] > 0
    _assert_rows_close(_session_rows(teng, "a"), _session_rows(jeng, "a"))
    if teng.cfg.kv_pages:
        teng.release_session("a")
        teng.release_session("b")
        teng.step()
        assert teng.metrics["kv_pages_free"] == teng.metrics["kv_pages_total"]
    jeng.stop()
    teng.stop()


@pytest.mark.parametrize("extra", [
    pytest.param(dict(spec_decode=2), id="spec"),
    pytest.param(dict(prefill_chunk_tokens=4), id="interleave"),
])
def test_ring_equal_jax_with_cotenants(jparams, tparams, extra):
    """Two live requests, then an arrival while they decode: verify steps
    and mixed steps ride the same ring; tokens, finishes and the ring,
    spec and interleave books equal the JAX ring engine's."""
    books = RING_BOOKS + ("spec_steps", "spec_proposed", "spec_accepted", "mixed_steps",
                          "interleaved_prefill_tokens")
    outs = []
    for eng in _pair(jparams, tparams, decode_ring=2, **extra):
        g = dict(temperature=0.0)
        hs = [eng.submit([1, 2, 3], _sp(eng, max_tokens=14, **g)),
              eng.submit([9, 8, 7, 6], _sp(eng, max_tokens=10, **g))]
        for _ in range(2):
            eng.step()
        hs.append(eng.submit(list(range(20, 35)), _sp(eng, max_tokens=6, **g)))
        _drain(eng)
        outs.append(([_record(h) for h in hs], {k: eng.metrics[k] for k in books}))
        eng.stop()
    assert outs[1] == outs[0]


def test_ring_grammar_eos_only_in_scan(jparams):
    """A grammar whose EOS (257) is cut off the 8-wide device stop row by
    eight caller stop ids: only the ring's per-slot grammar EOS stops the
    slot on the device. The port's ring engine gives the JAX ring
    engine's tokens and books, the stream ends STOP on the EOS, and the
    rest of its chunk is skipped (early_exit_steps)."""
    model_kw = dict(vocab_size=259)
    jp = jllama.init_params(jget_config("test-tiny", **model_kw), jax.random.key(3),
                            dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    g = jcompile_json_schema({"type": "object", "properties": {"ok": {"type": "boolean"}},
                              "required": ["ok"]}, JByteTokenizer())
    assert g.eos_id == 257
    stops = tuple(range(1, 9))   # never admissible inside this grammar
    outs = []
    for port, params in ((False, jp), (True, tp)):
        eng = _engine(port, params, model_kw=model_kw, decode_ring=2, grammar=True,
                      grammar_max_states=64, max_seq=128, decode_chunk=8)
        if port:
            assert eng._geos is not None
        h = eng.submit(list(b"json please"), _sp(eng, temperature=0.0, max_tokens=40,
                                                 stop_token_ids=stops), grammar=g)
        _drain(eng)
        outs.append((_record(h), _books(eng), eng.metrics["grammar_rejections_avoided"]))
        eng.stop()
    assert outs[1] == outs[0]
    (toks, reason, _n, _gen), books, avoided = outs[1]
    assert reason == "stop" and avoided == 1 and books["early_exit_steps"] > 0
    assert isinstance(json.loads(bytes(toks))["ok"], bool)


def test_mid_scan_deadline_exact_partial_counts(jparams, tparams):
    """The deadline-step budget: a far wall deadline over a huge step EMA
    converts to one step, so the slot emits exactly one decode token and
    finishes DEADLINE at the step the device masked it; streamed tokens
    == num_generated == 2, as in the JAX ring engine."""
    outs = []
    for eng in _pair(jparams, tparams, decode_ring=2):
        eng._devloop.step_ema_s = 1e4
        h = eng.submit([1, 2, 3], _sp(eng, temperature=0.0, max_tokens=32), deadline_s=60.0)
        _drain(eng)
        outs.append((_record(h), _books(eng)))
        eng.stop()
    assert outs[1] == outs[0]
    (toks, reason, _n, generated), books = outs[1]
    assert reason == "deadline" and generated == len(toks) == 2
    assert books["deadline_exceeded"] == 1 and books["early_exit_steps"] > 0


def test_cancel_mid_ring_exact_partial_counts(jparams, tparams):
    outs = []
    for eng in _pair(jparams, tparams, decode_ring=2):
        h = eng.submit([1, 2, 3], _sp(eng, temperature=0.0, max_tokens=48))
        for _ in range(3):
            eng.step()
        assert eng._inflight
        h.cancel()
        _drain(eng)
        outs.append((_record(h), _books(eng)))
        eng.stop()
    assert outs[1] == outs[0]
    (toks, reason, _n, generated), _ = outs[1]
    assert reason == "cancelled" and generated == len(toks)


def test_ring_watchdog_trip_and_recovery_equal_jax(jparams, tparams):
    """A hang injected on the drainer thread (the read starts at dispatch
    on the ring) trips the watchdog, poisons the drainer and fails the
    request with its streamed count; recovery reallocates and a fresh
    drainer serves the JAX engine's tokens afterwards."""
    outs = []
    for port, params, plan_cls in ((False, jparams, jfaults.FaultPlan),
                                   (True, tparams, tfaults.FaultPlan)):
        eng = _engine(port, params, decode_ring=2, watchdog_s=WATCHDOG_S)
        eng._fault_plan = plan_cls(hang_dispatch_s=HANG_S, hang_count=1)
        h = eng.submit([1, 2, 3], _sp(eng, temperature=0.0, max_tokens=12))
        with pytest.raises(RuntimeError, match="watchdog"):
            _drain(eng)
        poisoned = eng._devloop._drainer
        assert poisoned.poisoned and not eng.healthy()
        eng._recover("watchdog tripped")
        assert eng.healthy()
        after = eng.generate([4, 5, 6], _sp(eng, temperature=0.0, max_tokens=8))[0]
        assert eng._devloop._drainer is not poisoned
        outs.append((_record(h), after, {k: eng.metrics[k] for k in (
            "watchdog_trips", "recoveries", "requests_finished")}))
        eng.stop()
    assert outs[1] == outs[0]
    assert outs[1][0][1] == "error" and outs[1][0][3] == len(outs[1][0][0])


def test_ring_stop_with_chunks_in_flight(jparams, tparams):
    """stop(drain=True) with chunks in flight: the stream's terminal
    arrives with its streamed count, as in the JAX engine, and the
    drainer thread is joined."""
    outs = []
    for eng in _pair(jparams, tparams, decode_ring=2):
        h = eng.submit([1, 2, 3], _sp(eng, temperature=0.0, max_tokens=48))
        for _ in range(4):
            eng.step()
        assert eng._inflight
        thread = eng._devloop._drainer._thread
        eng.stop(drain=True)
        assert eng._devloop._drainer is None and not thread.is_alive()
        outs.append((_record(h), _books(eng)))
    assert outs[1] == outs[0]
    assert outs[1][0][3] == len(outs[1][0][0])


def test_full_ring_stall_books_and_preserves_stream(jparams, tparams):
    """decode_pipeline=4 wants four unread chunks where the ring holds
    two: dispatches process the oldest first (ring_full_stalls, equal to
    the JAX engine's), and the tokens are the ring-off engine's."""
    outs = []
    for eng in _pair(jparams, tparams, decode_ring=2, decode_pipeline=4, decode_chunk=2):
        h = eng.submit([5, 6, 7], _sp(eng, temperature=0.0, max_tokens=24))
        _drain(eng)
        outs.append((_record(h), _books(eng)))
        eng.stop()
    off = _engine(True, tparams, decode_pipeline=4, decode_chunk=2)
    h = off.submit([5, 6, 7], SamplingParams(temperature=0.0, max_tokens=24))
    _drain(off)
    assert outs[1] == outs[0] and outs[1][0] == _record(h)
    assert outs[1][1]["ring_full_stalls"] > 0


def test_moe_ring_equal_jax():
    """test-tiny-moe (E = 4) on the int8 + paged cache with the ring: the
    JAX ring engine's tokens, finishes and books."""
    jcfg = jget_config("test-tiny-moe")
    jp = jllama.init_params(jcfg, jax.random.key(5), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    fields = dict(decode_ring=3, kv_quant="int8", kv_pages=9, kv_page_tokens=16,
                  decode_chunk=4)
    outs = []
    for port, params in ((False, jp), (True, tp)):
        eng = _engine(port, params, model="test-tiny-moe", **fields)
        hs = [eng.submit([1, 2, 3, 4, 5], _sp(eng, temperature=0.0, max_tokens=11)),
              eng.submit([7, 7, 2], _sp(eng, temperature=0.0, max_tokens=6))]
        _drain(eng)
        outs.append(([_record(h) for h in hs], _books(eng)))
        eng.stop()
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# Wiring: flight events, warmup, the provider path
# ---------------------------------------------------------------------------


def test_ring_drains_are_flight_events_and_warmup_runs_the_ring(tparams, tmp_path,
                                                               monkeypatch):
    """A ring engine with the recorder records one ring_drain event per
    async drain, after a warmup that runs each ring chunk size with the
    ring's operands (grammar EOS and deadline budget) and restores the
    metrics; build_engine passes decode_ring through."""
    monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(tmp_path))
    eng = _engine(True, tparams, decode_ring=2, flight_events=256, grammar=True,
                  grammar_max_states=64)
    eng.warmup()
    assert eng.metrics["warmup_programs_done"] == eng.metrics["warmup_programs_total"]
    assert eng.metrics["ring_drains"] == 0 and eng.metrics["decode_steps"] == 0
    h = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=10))
    _drain(eng)
    assert _record(h)[1] == "length"
    deadline = time.monotonic() + 5
    while (len(eng._flight.events("ring_drain")) < eng.metrics["ring_drains"]
           and time.monotonic() < deadline):
        time.sleep(0.01)   # the drainer records after the engine's wait returns
    drains = eng._flight.events("ring_drain")
    assert len(drains) == eng.metrics["ring_drains"] > 0
    assert all(e.attrs["buffers"] == 1 and e.attrs["tokens"] > 0 for e in drains)
    eng.stop()
    built = build_engine(ProviderSpec(name="r", model="test-tiny",
                                      options=dict(BASE, decode_ring=2)), device="cpu")
    assert built.cfg.decode_ring == 2 and built._devloop.ring == 2
    built.stop()


def test_step_collectives_count_each_op_of_the_first_captured_step():
    """``RingGraphs``' tally of one captured step (on the card it runs
    inside the capture; here on Comms with no group, through
    ``Comm._tally``): per axis the step's calls, bytes and calls per op,
    an axis without a call left out, and only the first step counted."""
    from omnia_tpu_torch.engine.graphs import RingGraphs
    from omnia_tpu_torch.parallel.collectives import Comm

    def comm():
        c = Comm.__new__(Comm)
        c.stats, c.op_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}, {}
        return c

    dp, tp, sp = comm(), comm(), comm()
    Comm._tally(tp, "all_reduce", 64, None)       # before the capture
    graphs = RingGraphs.__new__(RingGraphs)
    graphs._comms, graphs.step_collectives = {"dp": dp, "tp": tp, "sp": sp}, {}
    for step in range(2):
        before = graphs._tallies()
        Comm._tally(dp, "all_reduce", 4, None)    # the predicate's OR
        for _ in range(3):                          # an MoE layer's counts each
            Comm._tally(dp, "all_gather", 32, None)
            Comm._tally(tp, "all_reduce", 1024, None)
        Comm._tally(tp, "all_gather", 512, None)
        graphs._count_step(before)
    assert graphs.step_collectives == {
        "dp": {"calls": 4, "bytes": 100, "ops": {"all_reduce": 1, "all_gather": 3}},
        "tp": {"calls": 4, "bytes": 3584, "ops": {"all_reduce": 3, "all_gather": 1}}}
