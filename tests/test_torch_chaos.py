"""The port's fault injection and hung-dispatch watchdog held against the
JAX package on the CPU (``test-tiny``, f32, the same converted params).

The ``FaultPlan`` copy fires as the JAX one does under one seeded call
order. A hang injected at a decode chunk's read trips the watchdog of
the port engine and of the JAX engine alike: the same trip and recovery
counts, the same ERROR partial, health back, and the same greedy tokens
afterwards, on the contiguous cache and on the int8 + paged one (whose
pages are then all free). Flaky submits raise on both, an uncounted
slow sync trips nothing, ``stop()`` does not wait for a poisoned
drainer, and without a watchdog and a plan no drainer thread exists."""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine import faults as jfaults
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import faults as tfaults
from omnia_tpu_torch.engine.devloop import DevLoopState
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

BASE = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16), dtype="float32", decode_chunk=2)
KV_CONFIGS = {
    "contiguous": dict(),
    "int8_paged": dict(kv_quant="int8", kv_pages=9, kv_page_tokens=16),
}
# The watchdog, and a hang five times as long: the trip lands at the
# watchdog, far from the hang's end, on a loaded host too.
WATCHDOG_S, HANG_S = 0.3, 1.5


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _engine(port: bool, params, **fields):
    f = dict(BASE, **fields)
    if port:
        return InferenceEngine(get_config("test-tiny"), EngineConfig(**f), params=params,
                               seed=0, device="cpu")
    return JEngine(jget_config("test-tiny"), JEngineConfig(**f), params=params, seed=0)


def _sp(engine, **kw):
    cls = SamplingParams if isinstance(engine, InferenceEngine) else JSamplingParams
    return cls(**kw)


def _events(handle, timeout: float = 30.0) -> tuple[list, object]:
    """Tokens up to the terminal, then a short grace window in which a
    second terminal would show (each request gets exactly one)."""
    tokens, finals = [], []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ev = handle._queue.get(timeout=0.05)
        except queue_mod.Empty:
            if finals:
                break
            continue
        if ev.token_id is not None:
            tokens.append(ev.token_id)
        if ev.is_final:
            finals.append(ev)
            deadline = min(deadline, time.monotonic() + 0.2)
    assert len(finals) == 1, finals
    return tokens, finals[0]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def test_fault_plan_fields_equal_jax():
    t = [(f.name, f.default) for f in dataclasses.fields(tfaults.FaultPlan)]
    j = [(f.name, f.default) for f in dataclasses.fields(jfaults.FaultPlan)]
    assert t == j
    assert issubclass(tfaults.WatchdogTimeout, RuntimeError)


@pytest.mark.parametrize("seed", range(3))
def test_fault_plan_fires_as_jax(seed):
    """The take_* seams under one seeded order of calls: the same answers
    and the same fired counts, every fault spent after its count."""
    rng = np.random.default_rng(seed)
    kw = dict(die_after_tokens=int(rng.integers(0, 3)), die_count=int(rng.integers(1, 4)),
              hang_dispatch_s=0.5, hang_count=int(rng.integers(1, 4)),
              flaky_submit=int(rng.integers(0, 4)), export_faults=int(rng.integers(0, 3)),
              slow_sync_s=0.01)
    t, j = tfaults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    seams = ["take_submit_fault", "take_export_fault", "take_death", "take_hang_s"]
    for name in rng.choice(seams, 60):
        assert getattr(t, name)() == getattr(j, name)()
    assert t.fired == j.fired
    assert t.fired["hangs"] == kw["hang_count"]


def test_fault_plan_is_thread_safe():
    """Eight threads race for a plan's 100 flaky submits: exactly 100 fire."""
    plan = tfaults.FaultPlan(flaky_submit=100)
    hits = []

    def worker():
        hits.append(sum(plan.take_submit_fault() for _ in range(50)))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert sum(hits) == plan.fired["submit_faults"] == 100


def test_drainer_lifecycle():
    """A read that outlives the wait poisons the drainer; the state hands
    out a fresh one; a read's exception reaches the waiter; stop()
    leaves nothing live."""
    st = DevLoopState()
    assert st.drainer_if_live() is None            # nothing until first use
    release = threading.Event()
    d = st.get_drainer()
    stuck = d.submit(lambda: release.wait(10) and np.arange(3))
    assert d.wait(stuck, timeout=0.05) is None and d.poisoned
    assert st.drainer_if_live() is None
    fresh = st.get_drainer()
    assert fresh is not d and st.drainer_if_live() is fresh
    assert (fresh.wait(fresh.submit(lambda: np.ones(2)), timeout=5) == 1).all()

    def broken():
        raise RuntimeError("read failed")

    with pytest.raises(RuntimeError, match="read failed"):
        fresh.wait(fresh.submit(broken), timeout=5)
    release.set()
    st.stop()
    assert st.drainer_if_live() is None


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _hang_run(engine, plan_cls) -> dict:
    """Two greedy requests queued, the loop started with a plan whose
    hang outlives the watchdog: the first chunk read trips it."""
    engine._fault_plan = plan_cls(hang_dispatch_s=HANG_S, hang_count=1)
    handles = [engine.submit([1, 2, 3], _sp(engine, temperature=0.0, max_tokens=12)),
               engine.submit([4, 5, 6, 7], _sp(engine, temperature=0.0, max_tokens=6))]
    engine.start()
    try:
        results = [_events(h) for h in handles]
        deadline = time.monotonic() + 10
        while not engine.healthy() and time.monotonic() < deadline:
            time.sleep(0.01)
        healthy = engine.healthy()
    finally:
        engine.stop()
    after = engine.generate([9, 8, 7, 6], _sp(engine, temperature=0.0, max_tokens=8))[0]
    m = engine.metrics
    return dict(
        results=[(toks, fin.finish_reason.value, fin.num_generated_tokens, fin.error)
                 for toks, fin in results],
        books={k: m[k] for k in ("watchdog_trips", "recoveries", "requests_submitted",
                                 "requests_finished")},
        fired=dict(engine._fault_plan.fired), healthy=healthy, after=after,
    )


@pytest.mark.parametrize("cache", list(KV_CONFIGS))
def test_watchdog_trip_equals_jax(jparams, tparams, cache):
    """The trip fails the request in flight with its streamed tokens as
    its partial count, recovery reallocates, health returns, the queued
    request is then served, and the greedy tokens after recovery are the
    JAX engine's; every page is free again."""
    fields = dict(KV_CONFIGS[cache], watchdog_s=WATCHDOG_S)
    jrun = _hang_run(_engine(False, jparams, **fields), jfaults.FaultPlan)
    teng = _engine(True, tparams, **fields)
    trun = _hang_run(teng, tfaults.FaultPlan)
    assert trun == jrun
    (toks, reason, generated, error), served = trun["results"]
    assert reason == "error" and generated == len(toks) and error == "engine step failed"
    assert served[1] == "length"
    assert trun["books"]["watchdog_trips"] == trun["books"]["recoveries"] == 1
    assert trun["healthy"]
    if teng.cfg.kv_pages:
        assert teng.metrics["kv_pages_free"] == teng.metrics["kv_pages_total"]


def test_trip_lands_at_the_watchdog(tparams):
    """The watchdog's wait, timed at the sync seam: the trip is raised
    between watchdog_s and watchdog_s + 0.5 s after the read began."""
    eng = _engine(True, tparams, watchdog_s=WATCHDOG_S)
    eng._fault_plan = tfaults.FaultPlan(hang_dispatch_s=HANG_S)
    waited = []
    sync = eng._sync_chunk_host

    def timed(ch):
        t0 = time.monotonic()
        try:
            return sync(ch)
        finally:
            waited.append(time.monotonic() - t0)

    eng._sync_chunk_host = timed
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=6))
    with pytest.raises(tfaults.WatchdogTimeout):
        while eng.step():
            pass
    assert len(waited) == 1 and WATCHDOG_S <= waited[0] <= WATCHDOG_S + 0.5
    assert not eng.healthy() and eng.metrics["watchdog_trips"] == 1
    eng._recover("tripped")
    assert eng.healthy() and eng.metrics["recoveries"] == 1
    eng.stop()


def test_flaky_submits_raise_as_in_jax(jparams, tparams):
    """The first two submits raise and count nowhere; the rest serve."""
    got = []
    for port, params, plan_cls in ((False, jparams, jfaults.FaultPlan),
                                   (True, tparams, tfaults.FaultPlan)):
        eng = _engine(port, params)
        eng._fault_plan = plan_cls(flaky_submit=2)
        raised, handles = 0, []
        for i in range(4):
            try:
                handles.append(eng.submit([1, 2, 3 + i],
                                          _sp(eng, temperature=0.0, max_tokens=4)))
            except RuntimeError as exc:
                assert "injected flaky submit" in str(exc)
                raised += 1
        while eng.step():
            pass
        got.append((raised, dict(eng._fault_plan.fired), eng.metrics["requests_submitted"],
                    [h.collect_tokens(timeout=30)[0] for h in handles]))
    assert got[1] == got[0]
    assert got[1][0] == 2 and got[1][2] == 2


def test_slow_sync_taxes_without_a_trip(tparams):
    """slow_sync_s below the watchdog: every chunk read waits it, nothing
    trips, the tokens are those of a plan-free engine."""
    sp = SamplingParams(temperature=0.0, max_tokens=9)
    plain = _engine(True, tparams).generate([3, 1, 4], sp)[0]
    eng = _engine(True, tparams, watchdog_s=1.0)
    eng._fault_plan = tfaults.FaultPlan(slow_sync_s=0.02)
    toks, fin = eng.generate([3, 1, 4], sp)
    assert toks == plain and fin.finish_reason.value == "length"
    m = eng.metrics
    assert m["watchdog_trips"] == 0 and m["recoveries"] == 0
    chunks = -(-(len(toks) - 1) // BASE["decode_chunk"])
    assert m["decode_sync_s"] >= 0.02 * chunks
    eng.stop()


def test_stop_does_not_wait_for_a_poisoned_drainer(tparams):
    """After a trip the old drainer is stuck in the hung read: stop()
    returns well before the hang ends."""
    eng = _engine(True, tparams, watchdog_s=0.1)
    eng._fault_plan = tfaults.FaultPlan(hang_dispatch_s=5.0)
    h = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=20))
    eng.start()
    _, fin = _events(h)
    assert fin.finish_reason.value == "error"
    t0 = time.monotonic()
    eng.stop()
    assert time.monotonic() - t0 < 2.0
    assert eng._thread is None


def test_no_watchdog_no_plan_no_drainer(tparams):
    """watchdog_s=None and no plan: no devloop state and no drainer
    thread, before or after serving."""
    before = set(threading.enumerate())
    eng = _engine(True, tparams)
    assert eng._devloop is None
    eng.start()
    try:
        eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=6)).collect_tokens(
            timeout=30)
        new = {th.name for th in set(threading.enumerate()) - before}
    finally:
        eng.stop()
    assert new == {"omnia-torch-engine"}
    assert eng._devloop is None
