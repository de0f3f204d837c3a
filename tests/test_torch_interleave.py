"""Stall-free batching in the port held against the JAX engine on the CPU
(``test-tiny``, f32, the same converted params, the JAX interleave
tests' engine fields), on the contiguous, int8, paged and int8 + paged
caches.

The JAX engine's own interleaved arm does not keep its KV rows equal to
its prefill-first arm (a piece attends the slot's resident rows where a
fresh prefill attends its own chunk; ROADMAP §C 1), so the port with
``prefill_chunk_tokens`` on is held against the JAX PLAIN arm for tokens,
finishes and KV rows, and against the JAX engine with the knob on for
the host books (``mixed_steps``, ``interleaved_prefill_tokens``,
``prefill_tokens``, ...), which do not depend on rounding."""

from __future__ import annotations

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.coordinator import EngineCoordinator
from omnia_tpu.engine.interleave import _InterleaveMixin as JInterleave
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.grammar import compile_json_schema
from omnia_tpu_torch.engine.interleave import _InterleaveMixin
from omnia_tpu_torch.engine.tokenizer import ByteTokenizer
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

BASE = dict(num_slots=4, max_seq=128, prefill_buckets=(8, 16, 32), dtype="float32",
            max_sessions=4)
CHUNK = 4
# 33 pages of 16 rows: every slot's 128 rows and the trash page.
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=33, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=33, kv_page_tokens=16),
}
# f32 rows: the piece's and the fresh prefill's reduction orders differ.
# int8 rows: a value within rounding of a .5 step may quantize to the
# neighbouring integer, so q may differ by one, and a row scale (absmax /
# 127) by the rounding of its f32 inputs.
KV_ATOL = 1e-6
SCALE_RTOL = 1e-6
BOOKS = ("mixed_steps", "interleaved_prefill_tokens", "prefill_tokens", "prefill_steps",
         "decode_steps", "decode_stall_steps", "prefix_reuse_tokens", "extend_steps",
         "requests_finished", "tokens_generated")
PROMPT_B = list(range(5, 35))                 # 30 tokens: 8 pieces of <= 4
LONG_C = [(7 * i) % 200 + 20 for i in range(126)]  # max_seq - 2: 1-token pieces at the end


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _engines(jparams, tparams, chunk=CHUNK, **fields):
    """(JAX plain arm, JAX with the knob on, the port with the knob on)."""
    f = dict(BASE, **fields)
    return (JEngine(jget_config("test-tiny"), JEngineConfig(**f), params=jparams, seed=0),
            JEngine(jget_config("test-tiny"), JEngineConfig(**f, prefill_chunk_tokens=chunk),
                    params=jparams, seed=0),
            InferenceEngine(get_config("test-tiny"),
                            EngineConfig(**f, prefill_chunk_tokens=chunk), params=tparams,
                            seed=0, device="cpu"))


def _sp(engine, **kw):
    cls = SamplingParams if isinstance(engine, InferenceEngine) else JSamplingParams
    return cls(**kw)


def _drain(engine):
    while engine.step():
        pass


def _record(handle) -> tuple:
    toks, fin = handle.collect_tokens(timeout=30)
    return toks, fin.finish_reason.value, fin.num_prompt_tokens, fin.num_generated_tokens


def _collect(handles) -> dict:
    return {label: _record(h) for label, h in handles.items()}


def _script(engine) -> dict:
    """A live greedy decoder; a 30-token and a 126-token arrival (the
    last pieces of which degrade to single tokens at the cache end); then
    turn 2 of the first arrival's session, reusing its rows."""
    g = dict(temperature=0.0)
    hs = {"a": engine.submit([1, 2, 3, 4], _sp(engine, max_tokens=90, **g))}
    for _ in range(3):
        engine.step()
    assert engine._slots[0].active  # decode is live when the arrivals land
    hs["b"] = engine.submit(PROMPT_B, _sp(engine, max_tokens=8, **g), session_id="b")
    hs["c"] = engine.submit(LONG_C, _sp(engine, max_tokens=4, **g), session_id="c")
    while not any(ev.is_final for ev in list(hs["b"]._queue.queue)):
        engine.step()
    out = {"b": _record(hs.pop("b"))}
    assert engine._slots[0].active
    hs["b2"] = engine.submit(PROMPT_B + out["b"][0] + [7, 8, 9],
                             _sp(engine, max_tokens=6, **g), session_id="b")
    _drain(engine)
    return dict(out, **_collect(hs))


def _leaves(kv) -> list:
    """Host arrays of an offloaded [L, rows, H, D] copy: (rows) or (q, s)."""
    if hasattr(kv, "q"):
        return [np.asarray(kv.q), np.asarray(kv.s)]
    return [np.asarray(kv)]


def _session_rows(engine, sid) -> list:
    """The session's valid rows, in the cache's representation."""
    sess = engine._sessions[sid]
    k, v = engine._offload_fn(engine._ck, engine._cv, sess.slot, len(sess.token_ids))
    return _leaves(k) + _leaves(v)


def _assert_rows_close(got: list, want: list):
    for x, y in zip(got, want, strict=True):
        assert x.shape == y.shape
        if x.dtype == np.int8:
            assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
        elif x.ndim == 3:   # int8 row scales [L, rows, H]
            np.testing.assert_allclose(x, y, rtol=SCALE_RTOL, atol=0)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=KV_ATOL)


@pytest.fixture(scope="module")
def script_runs(jparams, tparams):
    cache = {}

    def run(name):
        if name not in cache:
            engines = _engines(jparams, tparams, **KV_CONFIGS[name])
            cache[name] = [(e, _script(e)) for e in engines]
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_tokens_and_finishes_equal_jax_plain_arm(script_runs, name):
    (_, plain), (_, _), (port, out) = script_runs(name)
    assert out == plain
    assert port.metrics["mixed_steps"] > 0


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_kv_rows_within_tolerance_of_jax_plain_arm(script_runs, name):
    """Both sessions' rows against the plain arm. On an int8 cache the
    plain arm's fresh prefill of session b attends its own float chunk
    where every piece attends quantized rows (the JAX package's
    documented asymmetry, which its own int8 interleave test avoids with
    a prompt longer than the largest bucket), so b's rows are held
    against the JAX interleaved arm there; session c, longer than the
    largest bucket, extends on both arms and is held against the plain
    arm on every cache."""
    (jplain, _), (jmixed, _), (port, _) = script_runs(name)
    ref_b = jmixed if "int8" in name else jplain
    _assert_rows_close(_session_rows(port, "b"), _session_rows(ref_b, "b"))
    _assert_rows_close(_session_rows(port, "c"), _session_rows(jplain, "c"))


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_books_equal_jax_with_knob_on(script_runs, name):
    (jplain, _), (jmixed, _), (port, _) = script_runs(name)
    assert {k: port.metrics[k] for k in BOOKS} == {k: jmixed.metrics[k] for k in BOOKS}
    # The 126-token arrival ran single-token pieces; decode never stalled.
    assert port.metrics["interleaved_prefill_tokens"] > len(PROMPT_B) + len(LONG_C) - 32
    assert port.metrics["decode_stall_steps"] == 0 < jplain.metrics["decode_stall_steps"]
    if port._pages is not None:
        assert port.metrics["kv_pages_free"] == jmixed.metrics["kv_pages_free"]


# Pieces of prompts that fit the cache (start + count <= max_seq - 2).
_GRID = [g for g in itertools.product((0, 5, 100, 120), (1, 3, 8, 27), (1, 4, 32, 100),
                                      (128, 512)) if g[0] + g[1] <= g[3] - 2]


@pytest.mark.parametrize("start,count,budget,max_seq", _GRID[::4] + [(119, 7, 4, 128),
                                                                     (124, 2, 16, 126)])
def test_budget_pieces_equal_jax(start, count, budget, max_seq):
    fields = dict(max_seq=max_seq, prefill_buckets=(8, 16, 32, 64), prefill_chunk_tokens=budget)
    jself = types.SimpleNamespace(cfg=JEngineConfig(**fields))
    tself = types.SimpleNamespace(cfg=EngineConfig(**fields))
    want = JInterleave._budget_pieces(jself, start, count)
    got = _InterleaveMixin._budget_pieces(tself, start, count)
    assert got == want
    assert sum(t for _o, t, _b in got) == count
    assert all(o + b <= max_seq for o, _t, b in got)


@pytest.mark.parametrize("name", ["int8_paged"])
def test_mid_prefill_deadline_and_cancel(jparams, tparams, name):
    """A deadline and then a cancel land mid-prefill: the JAX engine's
    partial books; the retry on the same session reuses exactly the
    consumed frontier and emits the plain arm's tokens; every submit
    ends once."""

    def script(engine):
        clock = [0.0]
        engine.clock = lambda: clock[0]
        g = dict(temperature=0.0)
        pb = list(range(10, 40))
        ha = engine.submit([1, 2, 3, 4], _sp(engine, max_tokens=90, **g))
        for _ in range(3):
            engine.step()
        hb = engine.submit(pb, _sp(engine, max_tokens=4, **g), session_id="s1",
                           deadline_s=5.0)
        engine.step()
        assert engine._prefilling is not None
        consumed = engine.metrics["interleaved_prefill_tokens"]
        clock[0] = 6.0
        engine.step()
        assert engine._prefilling is None
        books = [{k: engine.metrics[k] for k in BOOKS + ("deadline_exceeded",)}]
        hb2 = engine.submit(pb, _sp(engine, max_tokens=4, **g), session_id="s1")
        _drain(engine)
        books.append({k: engine.metrics[k] for k in BOOKS + ("deadline_exceeded",)})
        ha2 = engine.submit([5, 6, 7], _sp(engine, max_tokens=40, **g))
        for _ in range(3):
            engine.step()
        hc = engine.submit(list(range(50, 80)), _sp(engine, max_tokens=4, **g))
        engine.step()
        assert engine._prefilling is not None
        hc.cancel()
        engine.step()
        assert engine._prefilling is None
        hd = engine.submit(list(range(60, 75)), _sp(engine, max_tokens=4, **g))
        _drain(engine)
        books.append({k: engine.metrics[k] for k in BOOKS + ("requests_submitted",)})
        return consumed, books, _collect({"a": ha, "b": hb, "b2": hb2, "a2": ha2, "c": hc,
                                          "d": hd})

    jplain, jmixed, port = _engines(jparams, tparams, **KV_CONFIGS[name])
    consumed, books, out = script(port)
    jconsumed, jbooks, jout = script(jmixed)
    assert (consumed, books) == (jconsumed, jbooks)
    assert 0 < consumed < 30
    assert out["b"][:2] == ([], "deadline") and out["c"][:2] == ([], "cancelled")
    assert books[1]["prefix_reuse_tokens"] - books[0]["prefix_reuse_tokens"] == consumed
    assert books[2]["requests_finished"] == books[2]["requests_submitted"] == 6
    assert out == jout
    want = jplain.generate(list(range(10, 40)), JSamplingParams(temperature=0.0, max_tokens=4))
    assert out["b2"][0] == want[0]
    # Paged: the abort trimmed to the consumed frontier, as the JAX engine's.
    assert port.metrics["kv_pages_free"] == jmixed.metrics["kv_pages_free"]


@pytest.mark.parametrize("name", ["contiguous"])
def test_grammar_slot_through_interleave(jparams, tparams, name):
    """A grammared slot decodes through mixed steps and a constrained
    request arrives (its first token takes the start-state bias in the
    final piece): the JAX plain arm's tokens, every one admissible."""
    g = compile_json_schema({"type": "object", "properties": {"a": {"type": "integer"}},
                             "required": ["a"]}, ByteTokenizer())
    jplain, _, port = _engines(jparams, tparams, max_sessions=0, grammar=True,
                               grammar_max_states=512, **KV_CONFIGS[name])
    outs = []
    for engine in (jplain, port):
        sp_g = _sp(engine, temperature=0.0, max_tokens=40, stop_token_ids=(0,))
        ha = engine.submit(list(b"make json"), sp_g, grammar=g)
        for _ in range(3):
            engine.step()
        hb = engine.submit(PROMPT_B, _sp(engine, temperature=0.0, max_tokens=6))
        hc = engine.submit(list(b"second json goes here, a long prompt"), sp_g, grammar=g)
        _drain(engine)
        outs.append(_collect({"a": ha, "b": hb, "c": hc}))
    assert outs[1] == outs[0]
    assert port.metrics["mixed_steps"] > 0 and port.metrics["decode_stall_steps"] == 0
    view = g.view(port.model_cfg.vocab_size, (0,))
    for label in ("a", "c"):
        s = view.start
        for t in outs[1][label][0]:
            assert view.allowed(s)[t]
            s = view.advance(s, t)


@pytest.mark.parametrize("name", ["paged"])
def test_prefix_seeded_interleaved_placement(jparams, tparams, name):
    """A fresh arrival seeded from the shared-prefix pool interleaves only
    its suffix: the plain arm's tokens, the JAX engine's hit and
    interleaved counts with the knob on."""
    sys_block = list(range(1, 25))

    def script(engine):
        g = dict(temperature=0.0)
        engine.register_prefix(sys_block)
        h0 = engine.submit(sys_block + [30], _sp(engine, max_tokens=2, **g))
        _drain(engine)
        ha = engine.submit([9, 9, 9], _sp(engine, max_tokens=40, **g))
        for _ in range(3):
            engine.step()
        hb = engine.submit(sys_block + [31, 32, 33], _sp(engine, max_tokens=6, **g))
        _drain(engine)
        return _collect({"0": h0, "a": ha, "b": hb})

    fields = dict(prefix_cache_slots=2, max_sessions=0, **KV_CONFIGS[name])
    jplain, jmixed, port = _engines(jparams, tparams, **fields)
    out, want = script(port), script(jplain)
    assert out == want
    script(jmixed)
    keys = ("prefix_cache_hit_tokens", "interleaved_prefill_tokens", "mixed_steps",
            "prefill_tokens", "kv_page_cow_copies")
    assert {k: port.metrics[k] for k in keys} == {k: jmixed.metrics[k] for k in keys}
    assert 0 < port.metrics["interleaved_prefill_tokens"] < len(sys_block)
    assert port.metrics["prefix_cache_hit_tokens"] > 0


def test_pending_prefill_tokens_equal_jax_and_feed_the_coordinator(jparams, tparams):
    """The backlog reads as the JAX engine's at every step of an
    interleave, and the JAX EngineCoordinator folds it into a port
    engine's load."""
    _, jmixed, port = _engines(jparams, tparams)
    seen = []
    for engine in (jmixed, port):
        engine.submit([1, 2, 3, 4], _sp(engine, temperature=0.0, max_tokens=40))
        for _ in range(3):
            engine.step()
        engine.submit(list(range(10, 40)), _sp(engine, temperature=0.0, max_tokens=4))
        trace = [engine.pending_prefill_tokens()]
        while engine.step():
            trace.append(engine.pending_prefill_tokens())
        seen.append(trace)
    assert seen[1] == seen[0]
    assert seen[1][0] == 30 and 0 < seen[1][1] < 30 and seen[1][-1] == 0

    busy, idle = (InferenceEngine(get_config("test-tiny"), EngineConfig(**BASE,
                                                                        prefill_chunk_tokens=4),
                                  params=tparams, device="cpu") for _ in range(2))
    for _ in range(4):
        busy.submit(list(range(1, 121)), SamplingParams(max_tokens=2))
    coord = EngineCoordinator([busy, idle])
    assert busy.pending_prefill_tokens() == 480
    assert coord._load(0) == 4 + 480 / 512 > coord._load(1) == 0.0
    assert coord._pick(None, [1, 2, 3]) == 1
