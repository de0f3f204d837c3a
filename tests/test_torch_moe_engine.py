"""The port's InferenceEngine serving MoE models held against the JAX
InferenceEngine on the CPU (f32, the same converted params, the same
EngineConfig field values): greedy tokens and finishes identical on the
contiguous, int8, paged and int8 + paged caches.

Two models: ``test-tiny-moe`` (E = 4, K = 2, where capacity dispatch can
drop nothing) and its E = 8 edition with a skewed router, where
prefills and extend pieces of 64 rows or more overflow expert 0's
capacity (the test counts the drops). The script places prompts in
buckets below and above 64 rows (more requests than slots), then runs a
two-turn session whose second turn extends in a 64-row piece. The same
holds with int8 weights (W8A16 on the attention and lm_head; router and
experts stay f32), and with ``prefill_chunk_tokens`` and ``spec_decode``
on: there the port is held against the JAX engine with both knobs off
for tokens and finishes, and against the JAX engine with them on for
the host books, as ``tests/test_torch_interleave.py`` and
``tests/test_torch_spec_decode.py`` hold the dense model."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.ops import moe as tmoe

BASE = dict(num_slots=2, max_seq=128, prefill_buckets=(16, 64, 128), decode_chunk=4,
            dtype="float32", max_sessions=4)
# 17 pages of 16 rows: both slots' 128 rows and the trash page.
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=17, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=17, kv_page_tokens=16),
}
KNOBS = dict(prefill_chunk_tokens=64, spec_decode=4)
BOOKS = ("mixed_steps", "interleaved_prefill_tokens", "spec_steps", "spec_proposed",
         "spec_accepted", "prefill_tokens", "prefix_reuse_tokens", "requests_finished",
         "tokens_generated")
# Prompt lengths: buckets 16 (all-expert), 64 and 128 (dispatch).
PROMPTS = (5, 40, 100, 20)


def _model(name: str):
    """(JAX config, port config, JAX f32 params) of a test model. The
    skewed E = 8 edition shifts every embedding by one shared vector u
    and points router column 0 along it, so that most rows of every layer
    rank expert 0 first and it overflows its capacity (N / 2 rows at
    capacity_factor 2)."""
    jcfg, tcfg = jget_config("test-tiny-moe"), get_config("test-tiny-moe")
    if name == "e8_skew":
        jcfg = dataclasses.replace(jcfg, num_experts=8)
        tcfg = dataclasses.replace(tcfg, num_experts=8)
    params = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(5),
                                                         dtype=jnp.float32))
    if name == "e8_skew":
        params = jax.tree.map(np.array, params)      # writable copies
        u = np.random.default_rng(6).standard_normal(jcfg.hidden_size).astype(np.float32)
        u *= 0.02
        params["embed"] += u
        params["layers"]["mlp"]["router"][:, :, 0] = 0.5 * u / np.linalg.norm(u)
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in ("tiny", "e8_skew")}


def _sp(engine, **kw):
    cls = SamplingParams if isinstance(engine, InferenceEngine) else JSamplingParams
    return cls(**kw)


def _drain(engine):
    while engine.step():
        pass


def _record(handle) -> tuple:
    toks, fin = handle.collect_tokens(timeout=30)
    return toks, fin.finish_reason.value, fin.num_prompt_tokens, fin.num_generated_tokens


def _script(engine, vocab: int) -> list:
    """Four greedy requests on two slots, then a two-turn session: turn 1
    of 30 tokens, turn 2 its prompt, its reply and 50 new tokens (one
    64-row extend piece)."""
    rng = np.random.default_rng(11)
    handles = [engine.submit([int(t) for t in rng.integers(1, vocab, n)],
                             _sp(engine, temperature=0.0, max_tokens=8 + n % 5))
               for n in PROMPTS]
    _drain(engine)
    out = [_record(h) for h in handles]
    turn1 = [int(t) for t in rng.integers(1, vocab, 30)]
    h = engine.submit(turn1, _sp(engine, temperature=0.0, max_tokens=6), session_id="s")
    _drain(engine)
    out.append(_record(h))
    turn2 = turn1 + out[-1][0] + [int(t) for t in rng.integers(1, vocab, 50)]
    h = engine.submit(turn2, _sp(engine, temperature=0.0, max_tokens=6), session_id="s")
    _drain(engine)
    out.append(_record(h))
    return out


@pytest.fixture
def dispatch_log(monkeypatch):
    """Every port dispatch's (B, T) and dropped assignments."""
    log = []
    real = tmoe.moe_dispatch

    def spy(h, p, k, capacity_factor=2.0, comm=None):
        B, T, _ = h.shape
        E = p["router"].shape[-1]
        capacity = max(1, int(-(-B * T * k * capacity_factor // E)))
        _, top_i = tmoe.route_sparse(h.reshape(B * T, -1), p["router"], k)
        counts = np.bincount(top_i.reshape(-1).numpy(), minlength=E)
        log.append((B, T, int(np.maximum(counts - capacity, 0).sum())))
        return real(h, p, k, capacity_factor, comm=comm)

    monkeypatch.setattr(tmoe, "moe_dispatch", spy)
    return log


@pytest.mark.parametrize("cache", sorted(KV_CONFIGS))
@pytest.mark.parametrize("model", ["tiny", "e8_skew"])
def test_streams_identical_to_jax(models, dispatch_log, model, cache):
    jcfg, tcfg, params = models[model]
    fields = dict(BASE, **KV_CONFIGS[cache])
    jeng = JEngine(jcfg, JEngineConfig(**fields), params=params, seed=0)
    teng = InferenceEngine(tcfg, EngineConfig(**fields), params=params_from_jax(params, "cpu"),
                           seed=0, device="cpu")
    want = _script(jeng, jcfg.vocab_size)
    assert _script(teng, tcfg.vocab_size) == want
    assert {r[1] for r in want} <= {"stop", "length"}
    assert teng.metrics["prefix_reuse_tokens"] == jeng.metrics["prefix_reuse_tokens"] > 0
    # Fresh prefills of the 64 and 128 buckets and the 64-row extend piece
    # dispatched; on the skewed model they dropped assignments.
    assert {(1, 64), (1, 128)} <= {(b, t) for b, t, _ in dispatch_log}
    drops = sum(d for _, _, d in dispatch_log)
    assert drops > 0 if model == "e8_skew" else drops == 0


@pytest.mark.parametrize("cache", ["contiguous", "int8_paged"])
def test_int8_weights_identical_to_jax(models, dispatch_log, cache):
    """``quant="int8"`` over full-precision params: each package quantizes
    attention and lm_head (W8A16) and leaves router and experts alone."""
    jcfg, tcfg, params = models["e8_skew"]
    fields = dict(BASE, quant="int8", **KV_CONFIGS[cache])
    jeng = JEngine(jcfg, JEngineConfig(**fields), params=params, seed=0)
    teng = InferenceEngine(tcfg, EngineConfig(**fields), params=params_from_jax(params, "cpu"),
                           seed=0, device="cpu")
    mlp = teng.params["layers"]["mlp"]
    assert all(not isinstance(v, dict) for v in mlp.values())
    assert isinstance(teng.params["layers"]["attn"]["wq"], dict)
    assert _script(teng, tcfg.vocab_size) == _script(jeng, jcfg.vocab_size)
    assert sum(d for _, _, d in dispatch_log) > 0


def _knob_script(engine) -> dict:
    """A live greedy decoder on a repetitive prompt (proposals accept);
    a 100-token arrival placed in pieces while it decodes; then a sampled
    request, riding the verify step's scan lane."""
    rep = [5, 6, 7, 8] * 6
    ha = engine.submit(rep, _sp(engine, temperature=0.0, max_tokens=40))
    for _ in range(2):
        engine.step()
    hb = engine.submit([(7 * i) % 200 + 20 for i in range(100)],
                       _sp(engine, temperature=0.0, max_tokens=12), session_id="b")
    _drain(engine)
    hc = engine.submit(rep[:10], _sp(engine, temperature=0.8, max_tokens=10, seed=3))
    _drain(engine)
    return {k: _record(h) for k, h in (("a", ha), ("b", hb), ("c", hc))}


@pytest.mark.parametrize("cache", ["contiguous", "int8_paged"])
def test_interleave_and_spec_on_identical_to_jax(models, cache):
    """test-tiny-moe with both knobs on: tokens and finishes equal the JAX
    engine's with the knobs off; the host books equal the JAX engine's
    with them on; pieces of 64 rows dispatch."""
    jcfg, tcfg, params = models["tiny"]
    fields = dict(BASE, **KV_CONFIGS[cache])
    jplain = JEngine(jcfg, JEngineConfig(**fields), params=params, seed=0)
    jon = JEngine(jcfg, JEngineConfig(**fields, **KNOBS), params=params, seed=0)
    teng = InferenceEngine(tcfg, EngineConfig(**fields, **KNOBS),
                           params=params_from_jax(params, "cpu"), seed=0, device="cpu")
    plain, on = _knob_script(jplain), _knob_script(jon)
    got = _knob_script(teng)
    # The sampled request's stream is the port's own (ROADMAP §C); the
    # greedy ones are the JAX engine's.
    assert {k: got[k] for k in "ab"} == {k: plain[k] for k in "ab"}
    assert got["c"][1:] == on["c"][1:]
    assert {k: teng.metrics[k] for k in BOOKS} == {k: jon.metrics[k] for k in BOOKS}
    assert teng.metrics["mixed_steps"] > 0 and teng.metrics["spec_accepted"] > 0
