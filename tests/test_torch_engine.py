"""The port's InferenceEngine held against the JAX InferenceEngine on the
CPU: the same converted ``test-tiny`` f32 params, the same EngineConfig
field values and the same greedy requests (more than slots, so admission
happens mid-decode) give identical tokens, finish reasons and counts —
with the contiguous KV cache, the int8 one, the paged one and both."""

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
from omnia_tpu.engine.paged import validate_paged_config as jvalidate_paged
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, FinishReason, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.paged import validate_paged_config
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

ENGINE_FIELDS = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32),
                     decode_chunk=4, dtype="float32")
PROMPT0 = [3, 1, 4, 1, 5, 9, 2]
# KV-cache configurations, each run against the JAX engine at the same
# field values. 20 pages of 16 rows hold both slots' full 64 rows.
KV_CONFIGS = {
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=20, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=20, kv_page_tokens=16),
}


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


@pytest.fixture(scope="module", autouse=True)
def manifest_dir(tmp_path_factory):
    """Every engine here keeps its warmup manifests in a directory of the
    test run's own, never in the package's build cache."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        d = tmp_path_factory.mktemp("manifests")
        monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3),
                              dtype=jnp.float32)


@pytest.fixture(scope="module")
def both_runs(jparams):
    jcfg = jget_config("test-tiny")
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


@pytest.mark.parametrize("knob", [dict(dp=2), dict(tp=2), dict(sp=2),
                                  dict(tp=2, decode_ring=2)])
def test_unported_knob_raises(knob):
    """dp, sp and tp are ported, but refused without a process group of
    dp * sp * tp ranks, with the decode ring as without it (on the CPU
    the ring runs at every degree; ``test_torch_ring_mesh.py`` holds its
    refusal on the card over gloo)."""
    match = "needs a torch.distributed process group of 2 ranks"
    with pytest.raises(ValueError, match=match):
        InferenceEngine(get_config("test-tiny"),
                        EngineConfig(**ENGINE_FIELDS, **knob), device="cpu")


def test_unported_submits_raise(both_runs):
    """A grammar on an engine built without grammar support ends at
    submit with the JAX engine's ERROR; a session turn and a prompt
    longer than the largest bucket (32) are served."""
    eng = both_runs["engine"]
    ev = eng.submit([1, 2, 3], SamplingParams(), grammar=object()).get_event(timeout=1)
    assert ev.finish_reason == FinishReason.ERROR
    assert ev.error == "grammar-constrained request on an engine built with grammar=off"
    assert eng.queue_depth() == 0
    sp = SamplingParams(temperature=0.0, max_tokens=3)
    handles = [eng.submit([1, 2, 3], sp, session_id="s1"),
               eng.submit(list(range(1, 41)), sp)]
    while eng.step():
        pass
    for h in handles:
        toks, fin = h.collect_tokens(timeout=5)
        assert fin.finish_reason == FinishReason.LENGTH and len(toks) == 3
    eng.release_session("s1")


def test_out_of_vocab_prompt_is_an_error(both_runs):
    ev = both_runs["engine"].submit([1, 256], SamplingParams()).get_event(timeout=1)
    assert ev.finish_reason.value == "error" and "token ids" in ev.error


# -- int8 and paged KV caches -------------------------------------------------


@pytest.fixture(scope="module")
def kv_runs(jparams, both_runs):
    """name → (JAX streams, port streams, port engine), run on demand."""
    subs = _requests(both_runs["stop_id"])
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    cache = {}

    def run(name):
        if name not in cache:
            fields = dict(ENGINE_FIELDS, **KV_CONFIGS[name])
            jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields),
                           params=jparams, seed=0)
            teng = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields),
                                   params=tparams, seed=0, device="cpu")
            teng.warmup()
            cache[name] = (_drive(jeng, subs, JSamplingParams),
                           _drive(teng, subs, SamplingParams), teng)
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_kv_streams_identical_to_jax(kv_runs, name):
    jax_out, torch_out, _ = kv_runs(name)
    assert torch_out == jax_out
    assert all(r[1] in ("stop", "length") for r in torch_out)


@pytest.mark.parametrize("paged,contiguous", [("paged", None), ("int8_paged", "int8")])
def test_paged_streams_identical_to_contiguous(kv_runs, both_runs, paged, contiguous):
    want = both_runs["out"][1] if contiguous is None else kv_runs(contiguous)[1]
    assert kv_runs(paged)[1] == want


@pytest.mark.parametrize("name", ["paged", "int8_paged"])
def test_pages_all_free_after_the_run(kv_runs, name):
    eng = kv_runs(name)[2]
    m = eng.metrics
    assert m["kv_pages_total"] == 19 and m["kv_pages_free"] == m["kv_pages_total"]
    assert m["kv_page_fragmentation"] == 0.0 and m["kv_page_cow_copies"] == 0
    assert eng._pages.slot_pages == [[], []]
    assert eng._ck.table.eq(0).all()  # every table row back at trash


def test_int8_metrics_count_the_allocation(kv_runs, both_runs):
    m8, m = kv_runs("int8")[2].metrics, both_runs["engine"].metrics
    cfg = get_config("test-tiny")
    assert m8["kv_quant_enabled"] == 1 and m["kv_quant_enabled"] == 0
    per_row = cfg.num_layers * cfg.num_kv_heads * 2
    assert m8["kv_quant_bytes_per_token"] == per_row * (cfg.head_dim + 4)
    assert m["kv_quant_bytes_per_token"] == per_row * cfg.head_dim * 4
    rows = ENGINE_FIELDS["num_slots"] * ENGINE_FIELDS["max_seq"]
    assert m8["kv_quant_device_bytes"] == rows * m8["kv_quant_bytes_per_token"]
    assert m["kv_quant_device_bytes"] == rows * m["kv_quant_bytes_per_token"]


def _tiny_engine(**fields):
    return InferenceEngine(get_config("test-tiny"), EngineConfig(**fields),
                           seed=3, device="cpu")


def test_decode_exhaustion_degrades_one_stream_not_the_batch():
    """7 usable pages of 16 rows against 2 slots that want 96 rows each:
    one slot finishes early with LENGTH, the other decodes on, nothing
    ERRORs and every page comes back."""
    eng = _tiny_engine(num_slots=2, max_seq=96, prefill_buckets=(16, 32),
                       dtype="float32", max_sessions=0, kv_pages=8, kv_page_tokens=16)
    sp = SamplingParams(temperature=0.0, max_tokens=80)
    h1 = eng.submit(list(range(1, 30)), sp)
    h2 = eng.submit(list(range(31, 60)), sp)
    while eng.step():
        pass
    fins = [h.collect_tokens(timeout=60)[1] for h in (h1, h2)]
    reasons = {f.finish_reason for f in fins}
    assert FinishReason.ERROR not in reasons and FinishReason.LENGTH in reasons
    assert all(f.num_generated_tokens > 0 for f in fins)
    assert sorted(f.num_generated_tokens for f in fins)[0] < 80 - 29
    assert eng.metrics["kv_pages_free"] == eng.metrics["kv_pages_total"] == 7


def test_placement_exhaustion_fails_the_request_not_the_engine():
    """1 usable page of 16 rows; a 20-token prompt's bucket of 32 rows
    needs two. Its request gets an ERROR terminal, the step raises to the
    loop's recovery, and the recovered engine serves again."""
    from omnia_tpu_torch.engine.kv_pages import PoolExhausted

    eng = _tiny_engine(num_slots=2, max_seq=64, prefill_buckets=(16, 32),
                       dtype="float32", kv_pages=2, kv_page_tokens=16)
    h = eng.submit(list(range(1, 21)), SamplingParams(temperature=0.0, max_tokens=4))
    with pytest.raises(PoolExhausted, match="exhausted"):
        while eng.step():
            pass
    _toks, fin = h.collect_tokens(timeout=10)
    assert fin.finish_reason == FinishReason.ERROR
    eng._recover("kv page pool exhausted")  # what the engine loop does
    h = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=2))
    while eng.step():
        pass
    toks, fin = h.collect_tokens(timeout=10)
    assert fin.finish_reason == FinishReason.LENGTH and len(toks) == 2
    assert eng.metrics["recoveries"] == 1 and eng.metrics["kv_pages_free"] == 1


@pytest.mark.parametrize("fields", [
    dict(kv_pages=1),
    dict(kv_pages=8, kv_page_tokens=48),
    dict(kv_pages=8, kv_page_tokens=0),
])
def test_validate_paged_config_messages_match_jax(fields):
    cfg = dict(num_slots=2, max_seq=64, prefill_buckets=(16,), dtype="float32", **fields)
    with pytest.raises(ValueError) as je:
        jvalidate_paged(JEngineConfig(**cfg), False)
    with pytest.raises(ValueError) as te:
        validate_paged_config(EngineConfig(**cfg))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="kv_page"):
        _tiny_engine(**cfg)
