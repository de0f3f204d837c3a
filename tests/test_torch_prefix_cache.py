"""The shared-prefix pool in the port held against the JAX engine on the
CPU, on the contiguous, int8, paged and int8 + paged KV caches: the same
converted ``test-tiny`` f32 params, the same EngineConfig field values
and the same greedy script give identical tokens, finish reasons,
``prefix_cache_*`` metrics and copy-on-write counts after every turn.
The script registers a pack prefix and seeds 6 sessions on 2 slots from
it, publishes two prefixes by the seen-twice threshold, evicts one to
the host tier and hits it there, elides the offload of a session the
pool covers, and resets the device pool. The radix books are held
against the JAX package's on a scripted sequence."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.prefix_cache import PrefixPool as JPrefixPool
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.prefix_cache import PrefixPool
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

ENGINE_FIELDS = dict(num_slots=2, max_seq=96, prefill_buckets=(32,), decode_chunk=4,
                     dtype="float32", max_sessions=12, prefix_cache_slots=2,
                     prefix_cache_host_entries=4, prefix_cache_min_tokens=4)
# 12 pages of 16 rows, 11 usable: less than both slots' full rows, so
# page pressure demotes prefix entries to the host tier where the
# contiguous pool's two entries demote under publish pressure.
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=12, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=12, kv_page_tokens=16),
}
METRICS = ("prefix_cache_hit_tokens", "prefix_cache_insertions", "prefix_cache_evictions",
           "prefix_cache_host_hits", "prefix_cache_offload_elisions", "kv_page_cow_copies",
           "prefill_tokens", "prefix_reuse_tokens", "session_offloads", "session_restores")
SYS = list(range(100, 140))        # a 40-token pack prefix: 2.5 pages of 16
P2 = list(range(150, 170))         # published by the seen-twice threshold
P3 = list(range(170, 190))
COVERED = list(range(200, 214))    # a session the pool covers whole


def _turn(engine, prompt, sid, sp_cls, max_tokens=4):
    h = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=max_tokens), session_id=sid)
    while engine.step():
        pass
    toks, fin = h.collect_tokens(timeout=5)
    return toks, fin.finish_reason.value, {k: engine.metrics[k] for k in METRICS}


def _script(engine, sp_cls):
    """The scripted traffic → {label: (tokens, finish, metrics after)}."""
    rng = np.random.default_rng(0)

    def text(n):
        return [int(t) for t in rng.integers(1, 99, n)]

    out, hist = {}, {}

    def turn(label, prompt, sid=None, **kw):
        out[label] = _turn(engine, prompt, sid, sp_cls, **kw)
        if sid:
            hist[sid] = prompt + out[label][0]

    engine.register_prefix(SYS)
    for i in range(6):                                   # 6 sessions, 2 slots
        turn(f"s{i}", SYS + text(3 + i), f"s{i}")
    for sid in ("s1", "s4"):                             # restored, extended
        turn(f"{sid}.2", hist[sid] + text(5), sid)
    turn("p2a", P2 + [1, 2])                             # seen once
    turn("p2b", P2 + [3, 4])                             # seen twice: publish
    turn("p3a", P3 + [1, 2])
    turn("p3b", P3 + [3, 4])                             # publish: P2 demoted
    turn("p2.host", P2 + [5, 6, 7], "h")                 # a host-tier hit
    engine.release_session("h")                          # unpins P2
    engine.register_prefix(COVERED + [0] * 20)
    turn("cov", COVERED, "cov", max_tokens=1)            # publishes COVERED over P2
    turn("x1", text(6), "x1", max_tokens=1)
    turn("x2", text(6), "x2", max_tokens=1)              # "cov" offload elided
    turn("cov.2", COVERED + [90, 91], "cov")             # rebuilt from the pool
    engine._recover("injected")                          # the device pool dies
    turn("cov.after", COVERED + [5, 5])                  # miss, published again
    turn("sys.after", SYS + [9, 9, 9], "after")          # host tier survived:
    turn("p3.after", P3 + [8])                           # both hit there
    return out


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def runs(jparams, tparams):
    """name → (JAX script, port script, port engine), run on demand."""
    cache = {}

    def run(name):
        if name not in cache:
            fields = dict(ENGINE_FIELDS, **KV_CONFIGS[name])
            jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields), params=jparams,
                           seed=0)
            teng = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields),
                                   params=tparams, seed=0, device="cpu")
            cache[name] = (_script(jeng, JSamplingParams), _script(teng, SamplingParams), teng)
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_script_identical_to_jax(runs, name):
    """Tokens, finish reasons, the five prefix_cache_* metrics,
    copy-on-write copies and the prefill / reuse / paging counts equal
    the JAX engine's after every turn."""
    jout, tout, _ = runs(name)
    assert list(tout) == list(jout)
    for label in jout:
        assert tout[label] == jout[label], label


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_script_exercises_the_pool(runs, name):
    """Each turn did what the script says: seeds of the registered
    prefix, threshold publishes, a demotion to the host tier and a hit
    there, an elided offload, and a miss after the device reset."""
    _, out, _ = runs(name)

    def delta(label, prev, key):
        return out[label][2][key] - out[prev][2][key]

    assert out["s0"][2]["prefix_cache_insertions"] == 1
    assert out["s5"][2]["prefix_cache_hit_tokens"] == 5 * len(SYS)
    assert out["s5"][2]["session_offloads"] > 0
    assert delta("s4.2", "s5", "session_restores") == 2
    assert delta("p2b", "p2a", "prefix_cache_insertions") == 1
    assert delta("p3b", "p3a", "prefix_cache_insertions") == 1
    assert out["p3b"][2]["prefix_cache_evictions"] > 0
    assert delta("p2.host", "p3b", "prefix_cache_host_hits") == 1
    assert delta("p2.host", "p3b", "prefix_cache_hit_tokens") == len(P2)
    assert delta("x2", "cov", "prefix_cache_offload_elisions") == 1
    assert delta("cov.2", "x2", "prefix_cache_hit_tokens") == len(COVERED)
    assert delta("cov.after", "cov.2", "prefix_cache_hit_tokens") == 0
    assert delta("cov.after", "cov.2", "prefix_cache_insertions") == 1
    assert delta("sys.after", "cov.after", "prefix_cache_host_hits") == 1
    assert delta("p3.after", "sys.after", "prefix_cache_host_hits") == 1
    if KV_CONFIGS[name].get("kv_pages"):
        # SYS ends mid-page, so every seeded suffix copies that page.
        assert out["s5"][2]["kv_page_cow_copies"] >= 5
    else:
        assert out["p3.after"][2]["kv_page_cow_copies"] == 0
    assert all(fin in ("stop", "length") for _, fin, _ in out.values())


@pytest.mark.parametrize("name", ["contiguous", "paged"])
def test_seeded_turn_equals_a_fresh_engine(runs, tparams, name):
    """f32 rows copied from the pool (or shared pages) give the tokens
    that a fresh prefill of the same prompt gives."""
    _, out, _ = runs(name)
    fresh = InferenceEngine(get_config("test-tiny"),
                            EngineConfig(**dict(ENGINE_FIELDS, prefix_cache_slots=0)),
                            params=tparams, seed=0, device="cpu")
    want = _turn(fresh, P2 + [5, 6, 7], None, SamplingParams)[0]
    assert out["p2.host"][0] == want


@pytest.mark.parametrize("name", ["paged", "int8_paged"])
def test_pages_all_free_after_release(runs, name):
    """Once every session is released and the prefix entries are
    dropped, every page is back on the free list."""
    _, _, eng = runs(name)
    for sid in list(eng._sessions):
        eng.release_session(sid)
    for e in eng._prefix_pool.entries():
        eng._prefix_pool.drop_entry(e)
    eng._update_page_metrics()
    assert eng.metrics["kv_pages_free"] == eng.metrics["kv_pages_total"]


def test_radix_pool_matches_jax():
    """PrefixPool's books (observe, register, insert, match, acquire,
    demote, drop, refcounts, device reset) against the JAX package's on
    one scripted sequence."""
    def drive(cls):
        pool, log = cls(2, 1, clock=iter(range(1000)).__next__), []
        a, b, c = tuple(range(10, 30)), tuple(range(10, 20)) + (7, 8, 9), tuple(range(40, 52))
        pool.register(c)
        log.append(pool.registered_candidate(list(c[:6]) + [1]))
        log += [pool.observe(list(a), 2), pool.observe(list(b), 2), pool.observe(list(a), 2)]
        ea = pool.insert(a, 32, *pool.acquire_slot()[:1])
        eb = pool.insert(b[:10], 16, *pool.acquire_slot()[:1])
        for q in (list(a) + [5], list(b), list(range(10, 15)), [99], list(a[:12]) + [0]):
            e, n = pool.match(q)
            log.append((e.tokens if e else None, n))
        pool.incref(ea)
        idx, victim = pool.acquire_slot()
        log.append((idx, victim.tokens if victim else None))
        pool.demoted_to_host(victim, "k", "v")
        victim.pool_idx = None
        ec = pool.insert(c, 16, idx)
        log.append([(e.tokens, e.pool_idx, e.host_k) for e in pool.entries()])
        idx2, victim2 = pool.acquire_slot()     # only the unpinned entry is a victim
        log.append((idx2, victim2.tokens if victim2 else None))
        pool.decref(ea.key)
        pool.drop_entry(ec)
        log.append(pool.on_device_reset())
        log.append(sorted((e.tokens, e.on_device, e.host_k) for e in pool.entries()))
        log.append((pool.evictions, eb.refs, ea.refs))
        return log

    got, want = drive(PrefixPool), drive(JPrefixPool)
    assert got == want
