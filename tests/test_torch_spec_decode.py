"""Speculative decoding in the port held against the JAX package on the
CPU (``test-tiny``, f32, the same converted params, the JAX spec tests'
engine fields).

The host half (``_NgramIndex``, ``spec_depth_update``, ``_SpecGate``,
``validate_spec_config``) gives the JAX copy's outputs on seeded random
inputs. The engine with ``spec_decode`` on is held against the JAX
engine with it OFF for tokens and finishes (the JAX spec arm's own
tokens are not held to its plain arm; ROADMAP §C 1), and against the
JAX engine with it on for the host books (``spec_steps``,
``spec_proposed``, ``spec_accepted``, ...). Sampled slots ride the exact
decode step, so their tokens equal the port's spec-off run."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import omnia_tpu.engine.spec_decode as jsd
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import spec_decode as tsd
from omnia_tpu_torch.engine.grammar import compile_json_schema
from omnia_tpu_torch.engine.tokenizer import ByteTokenizer
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

BASE = dict(num_slots=2, max_seq=128, prefill_buckets=(16,), dtype="float32",
            decode_chunk=4, max_sessions=4)
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=17, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=17, kv_page_tokens=16),
}
BOOKS = ("spec_steps", "spec_proposed", "spec_accepted", "spec_accept_ema", "decode_steps",
         "tokens_generated", "prefill_tokens", "prefix_reuse_tokens", "requests_finished")
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
PLAIN = [9, 3, 14, 2, 7]


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _engine(port: bool, spec: int, params, **fields):
    f = dict(BASE, spec_decode=spec, **fields)
    if port:
        return InferenceEngine(get_config("test-tiny"), EngineConfig(**f), params=params,
                               seed=0, device="cpu")
    return JEngine(jget_config("test-tiny"), JEngineConfig(**f), params=params, seed=0)


def _sp(engine, **kw):
    cls = SamplingParams if isinstance(engine, InferenceEngine) else JSamplingParams
    return cls(**kw)


def _drain(engine):
    while engine.step():
        pass


def _record(handle) -> tuple:
    toks, fin = handle.collect_tokens(timeout=30)
    return toks, fin.finish_reason.value, fin.num_generated_tokens


# ---------------------------------------------------------------------------
# The host half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_ngram_index_equals_jax(seed, monkeypatch):
    """Proposals, real counts and the index's books after every append
    of a seeded stream, with a small cap so that eviction and the
    survival of recurring grams happen."""
    monkeypatch.setattr(jsd, "_NGRAM_CAP", 16)
    monkeypatch.setattr(tsd, "_NGRAM_CAP", 16)
    rng = np.random.default_rng(seed)
    vocab = (3, 6, 12, 40)[seed]
    ctx = [int(t) for t in rng.integers(0, vocab, 8)]
    j, t = jsd._NgramIndex(), tsd._NgramIndex()
    for _ in range(120):
        k = int(rng.integers(1, 6))
        assert t.propose(ctx, k) == j.propose(ctx, k)
        assert (t.maps, t.built) == (j.maps, j.built)
        ctx += [int(x) for x in rng.integers(0, vocab, int(rng.integers(1, 4)))]
    assert t.entries() == j.entries() > 0


@pytest.mark.parametrize("kmax", [0, 1, 4, 8])
def test_spec_depth_update_equals_jax(kmax):
    rng = np.random.default_rng(kmax)
    ema_j = ema_t = 0.5
    for _ in range(200):
        real = int(rng.integers(0, 9))
        acc = int(rng.integers(0, real + 1))
        ema_j, k_j = jsd.spec_depth_update(ema_j, real, acc, kmax)
        ema_t, k_t = tsd.spec_depth_update(ema_t, real, acc, kmax)
        assert (ema_t, k_t) == (ema_j, k_j)


@pytest.mark.parametrize("window,hold", [(0, 8), (3, 2), (10, 8)])
def test_spec_gate_equals_jax(window, hold):
    """The same ticks on a fake clock: the same permits, states, rates
    and report."""
    rng = np.random.default_rng(window)
    j, t = jsd._SpecGate(window, hold_factor=hold), tsd._SpecGate(window, hold_factor=hold)
    now, toks = 100.0, 0
    for _ in range(400):
        now += float(rng.uniform(0.001, 0.05))
        toks += int(rng.integers(0, 20))
        assert t.tick(now, toks) == j.tick(now, toks)
        assert (t.state, t.state_code(), t.decisions, t.disables) == \
            (j.state, j.state_code(), j.decisions, j.disables)
    assert t.report() == j.report()


_VALIDATE_GRID = list(itertools.product((0, 2, 4, 8), (0, 3, 8, 16), (-1, 0, 4),
                                        ((8,), (16, 32), (4, 64))))


@pytest.mark.parametrize("chunk", range(4))
def test_validate_spec_config_equals_jax(chunk):
    for spec, smax, gate, buckets in _VALIDATE_GRID[chunk::4]:
        f = dict(prefill_buckets=buckets, spec_decode=spec, spec_decode_max=smax,
                 spec_gate_window=gate)
        errors = []
        for mod, cls in ((jsd, JEngineConfig), (tsd, EngineConfig)):
            try:
                mod.validate_spec_config(cls(**f))
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[1] == errors[0], f
        assert EngineConfig(**f).spec_window() == JEngineConfig(**f).spec_window()


# ---------------------------------------------------------------------------
# The engine, on every cache
# ---------------------------------------------------------------------------


def _script(engine) -> tuple[dict, list]:
    """A sampled and a greedy slot side by side; a greedy stream stopped
    by a stop id; a session's turn 2 over rows written by verify windows.
    Returns (records, the books after each part)."""
    g = dict(temperature=0.0)
    out, books = {}, []
    hs = engine.submit(PLAIN, _sp(engine, temperature=0.8, top_p=0.9, top_k=40,
                                  max_tokens=10, seed=7))
    hg = engine.submit(REPETITIVE, _sp(engine, max_tokens=60, **g))
    _drain(engine)
    out["sampled"], out["greedy"] = _record(hs), _record(hg)
    books.append({k: engine.metrics[k] for k in BOOKS})
    # A stop id the greedy stream emits at its 8th token.
    stop = out["greedy"][0][7]
    h = engine.submit(REPETITIVE, _sp(engine, max_tokens=24, stop_token_ids=(stop,), **g))
    _drain(engine)
    out["stop"] = _record(h)
    h = engine.submit(REPETITIVE, _sp(engine, max_tokens=24, **g), session_id="s")
    _drain(engine)
    out["turn1"] = _record(h)
    h = engine.submit(REPETITIVE + out["turn1"][0] + [9], _sp(engine, max_tokens=24, **g),
                      session_id="s")
    _drain(engine)
    out["turn2"] = _record(h)
    books.append({k: engine.metrics[k] for k in BOOKS})
    return out, books


@pytest.fixture(scope="module")
def script_runs(jparams, tparams):
    cache = {}

    def run(name):
        if name not in cache:
            f = KV_CONFIGS[name]
            cache[name] = dict(
                jax_off=_script(_engine(False, 0, jparams, **f)),
                jax_on=_script(_engine(False, 4, jparams, **f)),
                port_off=_script(_engine(True, 0, tparams, **f)),
                port_on=_script(_engine(True, 4, tparams, **f)))
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_greedy_tokens_equal_jax_spec_off(script_runs, name):
    runs = script_runs(name)
    got, want = runs["port_on"][0], runs["jax_off"][0]
    for label in ("greedy", "stop", "turn1", "turn2"):
        assert got[label] == want[label], label
    assert got["stop"][1] == "stop"
    assert runs["port_on"][1][1]["prefix_reuse_tokens"] > 0


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_spec_books_equal_jax_spec_on(script_runs, name):
    runs = script_runs(name)
    assert runs["port_on"][1] == runs["jax_on"][1]
    assert runs["port_on"][1][0]["spec_accepted"] > 0


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_sampled_slot_equals_port_spec_off(script_runs, name):
    """The sampled slot rode verify_decode's scan lane beside the
    verifying greedy slot: its tokens are the plain engine's."""
    runs = script_runs(name)
    assert runs["port_on"][0]["sampled"] == runs["port_off"][0]["sampled"]
    assert len(runs["port_on"][0]["sampled"][0]) == 10


def test_grammared_slot_speculates(jparams, tparams):
    """A grammared greedy slot speculates through the masked oracle: the
    JAX spec-off engine's tokens, each admissible; the unconstrained
    neighbour is unaffected; the books equal the JAX spec-on engine's."""
    g = compile_json_schema({"type": "object",
                             "properties": {"a": {"type": "integer"}, "ok": {"type": "boolean"}},
                             "required": ["a", "ok"]}, ByteTokenizer())
    over = dict(grammar=True, grammar_max_states=512)

    def script(engine):
        hg = engine.submit(list(b"make json"),
                           _sp(engine, temperature=0.0, max_tokens=100, stop_token_ids=(0,)),
                           grammar=g)
        hf = engine.submit(REPETITIVE, _sp(engine, temperature=0.0, max_tokens=60))
        _drain(engine)
        return (_record(hg), _record(hf)), {k: engine.metrics[k] for k in BOOKS}

    port_out, port_books = script(_engine(True, 4, tparams, **over))
    want, _ = script(_engine(False, 0, jparams, **over))
    _, jbooks = script(_engine(False, 4, jparams, **over))
    assert port_out == want
    assert port_books == jbooks and port_books["spec_steps"] > 0
    view = g.view(get_config("test-tiny").vocab_size, (0,))
    s = view.start
    for t in port_out[0][0]:
        assert view.allowed(s)[t]
        s = view.advance(s, t)


def _count_calls(engine) -> list:
    """Wrap an engine's mixed_spec programs; the list gets one entry per
    call."""
    calls = []
    for fns in (engine._mixed_spec_fns, engine._mixed_spec_sample_fns):
        for b, fn in list(fns.items()):
            def counted(*a, _fn=fn):
                calls.append(1)
                return _fn(*a)
            fns[b] = counted
    return calls


def test_spec_with_interleave_rides_the_mixed_step(jparams, tparams):
    """A greedy slot whose stream has turned repetitive verifies inside
    mixed steps (``mixed_spec``) while a prompt's pieces stream: the JAX
    engine's tokens with both knobs off, its books and its count of
    fused steps with both on, on the int8 + paged cache."""
    f = dict(prefill_chunk_tokens=8, prefill_buckets=(16, 32), **KV_CONFIGS["int8_paged"])

    def script(engine):
        calls = _count_calls(engine)
        h1 = engine.submit(REPETITIVE, _sp(engine, temperature=0.0, max_tokens=60))
        for _ in range(16):
            engine.step()
        h2 = engine.submit(list(range(60, 120)), _sp(engine, temperature=0.0, max_tokens=8))
        _drain(engine)
        books = {k: engine.metrics[k]
                 for k in BOOKS + ("mixed_steps", "interleaved_prefill_tokens")}
        return (_record(h1), _record(h2)), dict(books, fused=len(calls))

    want, _ = script(_engine(False, 0, jparams, **dict(f, prefill_chunk_tokens=0)))
    _, jbooks = script(_engine(False, 4, jparams, **f))
    got, books = script(_engine(True, 4, tparams, **f))
    assert got == want
    assert books == jbooks
    assert books["fused"] > 0 and books["mixed_steps"] > 0


def test_deadline_and_cancel_keep_exact_ledgers(jparams, tparams):
    """A deadline and a cancel between verify steps: streamed tokens
    equal num_generated_tokens, every submit ends once, and the books
    equal the JAX spec-on engine's."""

    def script(engine):
        now = [1000.0]
        engine.clock = lambda: now[0]
        g = dict(temperature=0.0, max_tokens=200)
        h = engine.submit(REPETITIVE, _sp(engine, **g), deadline_s=50.0)
        for _ in range(6):
            engine.step()
        now[0] += 100.0
        _drain(engine)
        h2 = engine.submit(REPETITIVE, _sp(engine, **g))
        for _ in range(6):
            engine.step()
        h2.cancel()
        _drain(engine)
        books = {k: engine.metrics[k] for k in BOOKS + ("deadline_exceeded",
                                                         "requests_submitted")}
        return (_record(h), _record(h2)), books

    got, books = script(_engine(True, 4, tparams))
    jgot, jbooks = script(_engine(False, 4, jparams))
    assert books == jbooks
    assert [r[1:] for r in got] == [r[1:] for r in jgot]
    (t1, f1, n1), (t2, f2, n2) = got
    assert (f1, f2) == ("deadline", "cancelled") and n1 == len(t1) > 0 and n2 == len(t2)
    assert books["requests_finished"] == books["requests_submitted"] == 2
    assert books["tokens_generated"] == len(t1) + len(t2)
