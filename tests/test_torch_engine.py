"""The port's InferenceEngine held against the JAX InferenceEngine on the
CPU: the same converted ``test-tiny`` f32 params, the same EngineConfig
field values and the same greedy requests (more than slots, so admission
happens mid-decode) give identical tokens, finish reasons and counts."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

ENGINE_FIELDS = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32),
                     decode_chunk=4, dtype="float32")
PROMPT0 = [3, 1, 4, 1, 5, 9, 2]


def _requests(stop_id):
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(t) for t in rng.integers(1, 256, size=n)]

    return [
        (PROMPT0, dict(max_tokens=10, stop_token_ids=(stop_id,))),
        (prompt(3), dict(max_tokens=5)),
        (prompt(12), dict(max_tokens=9)),
        (prompt(20), dict(max_tokens=3)),
        (prompt(30), dict(max_tokens=40)),   # stops at the max_seq - 2 limit
        (prompt(9), dict(max_tokens=14)),
    ]


def _drive(engine, submissions, sp_cls):
    handles = [engine.submit(p, sp_cls(temperature=0.0, **kw)) for p, kw in submissions]
    while engine.step():
        pass
    out = []
    for h in handles:
        toks, fin = h.collect_tokens(timeout=5)
        out.append((toks, fin.finish_reason.value, fin.num_prompt_tokens,
                    fin.num_generated_tokens))
    return out


@pytest.fixture(scope="module")
def both_runs():
    jcfg = jget_config("test-tiny")
    jparams = jllama.init_params(jcfg, jax.random.key(3), dtype=jnp.float32)
    jeng = JEngine(jcfg, JEngineConfig(**ENGINE_FIELDS), params=jparams, seed=0)
    free_run = _drive(jeng, [(PROMPT0, dict(max_tokens=10))], JSamplingParams)[0][0]
    stop_id = free_run[3]
    subs = _requests(stop_id)
    jax_out = _drive(jeng, subs, JSamplingParams)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    teng = InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS),
                           params=tparams, seed=0, device="cpu")
    teng.warmup()
    torch_free = _drive(teng, [(PROMPT0, dict(max_tokens=10))], SamplingParams)[0][0]
    torch_out = _drive(teng, subs, SamplingParams)
    return dict(free=(free_run, torch_free), out=(jax_out, torch_out),
                stop_id=stop_id, engine=teng)


def test_streams_identical_to_jax(both_runs):
    jfree, tfree = both_runs["free"]
    assert tfree == jfree
    jax_out, torch_out = both_runs["out"]
    assert torch_out == jax_out
    reasons = [r[1] for r in torch_out]
    assert reasons[0] == "stop" and "length" in reasons
    assert torch_out[0][0] == jfree[:3]
    assert torch_out[4][3] < 40   # capped by max_seq - 2, not max_tokens


def test_metrics_count_the_run(both_runs):
    m = both_runs["engine"].metrics
    assert m["requests_submitted"] == m["requests_finished"] == 7
    assert m["tokens_generated"] == sum(len(r[0]) for r in both_runs["out"][1]) + 10
    assert m["prefill_steps"] == 7 and m["decode_steps"] > 0


def test_engine_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert tf == jf


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS))


@pytest.mark.parametrize("knob", [dict(kv_quant="int8"), dict(kv_pages=8),
                                  dict(grammar=True), dict(tp=2),
                                  dict(spec_decode=2), dict(decode_ring=2)])
def test_unported_knob_raises(knob):
    with pytest.raises(ValueError, match="ROADMAP"):
        InferenceEngine(get_config("test-tiny"),
                        EngineConfig(**ENGINE_FIELDS, **knob), device="cpu")


def test_unported_submits_raise(both_runs):
    eng = both_runs["engine"]
    with pytest.raises(ValueError, match="A6"):
        eng.submit([1, 2, 3], SamplingParams(), session_id="s1")
    with pytest.raises(ValueError, match="A6"):
        eng.submit(list(range(1, 41)), SamplingParams())
    assert eng.queue_depth() == 0


def test_out_of_vocab_prompt_is_an_error(both_runs):
    ev = both_runs["engine"].submit([1, 256], SamplingParams()).get_event(timeout=1)
    assert ev.finish_reason.value == "error" and "token ids" in ev.error
