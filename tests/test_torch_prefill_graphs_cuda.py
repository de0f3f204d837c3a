"""The captured fresh prefill on a card (``omnia_tpu_torch/engine/
prefill_graphs.py``): a replay against the eager ``prefill_insert`` on a
copy of the same state, the other slots' rows, the eager program on any
other state, the recapture after the state is reallocated, the counter,
and the benchmark's event pairs around the replays. This file imports
neither jax nor omnia_tpu (the machine with the card has neither), so
run it there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_prefill_graphs_cuda.py -q -s

Here, on a host without a card, every test skips. The engines have
Mistral-7B's widths at 4 layers (32 slots, buckets 64-256) and
Mixtral-8x7B's at 2 layers, whose buckets of 64 rows and more run the
MoE's capacity dispatch."""

from __future__ import annotations

import pytest
import torch

from omnia_tpu_torch.models.kv_quant import QuantKV, kv_map


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


@pytest.fixture(autouse=True)
def manifest_dir(tmp_path, monkeypatch):
    """Every engine here keeps its warmup manifests in the test's own
    directory."""
    monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(tmp_path / "manifests"))


def _engine(name: str = "mistral-4l", **fields):
    from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
    from omnia_tpu_torch.models import ModelConfig, get_config

    if name == "mistral-4l":
        cfg = ModelConfig(name=name, vocab_size=32768, hidden_size=4096, num_layers=4,
                          num_heads=32, num_kv_heads=8, head_dim=128, ffn_hidden_size=14336,
                          rope_theta=1e6, max_seq_len=2048)
    else:
        cfg = get_config("mixtral-8x7b", num_layers=2, max_seq_len=2048)
    fields = dict(dict(num_slots=32, max_seq=1024, prefill_buckets=(64, 128, 256),
                       dtype="bfloat16", decode_ring=2, decode_chunk=8,
                       decode_chunk_variants=()), **fields)
    return InferenceEngine(cfg, EngineConfig(**fields), seed=0, device="cuda")


def _prompts(n: int, seed: int, lo: int = 20, hi: int = 250) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 32000, (int(n_tok),), generator=g).tolist()
            for n_tok in torch.randint(lo, hi, (n,), generator=g)]


def _serve(eng, prompts, max_tokens=12):
    from omnia_tpu_torch.engine import SamplingParams

    hs = [eng.submit(p, SamplingParams(temperature=0.0 if i % 2 else 0.7, top_p=0.9,
                                       top_k=40, max_tokens=max_tokens, seed=100 + i))
          for i, p in enumerate(prompts)]
    while eng.step():
        pass
    torch.cuda.synchronize()
    return [h.collect_tokens(timeout=120)[0] for h in hs]


def _clone(c):
    return kv_map(lambda a: a.clone(), c)


def _leaves(c) -> tuple:
    return (c.q, c.s) if isinstance(c, QuantKV) else (c,)


def _operands(eng, bucket: int, n: int, greedy: bool, seed: int) -> tuple:
    """Tokens and positions [1, bucket] holding an n-token prompt, and the
    first-token sampler's operands (a grammar's bias where grammar is on)."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :n] = torch.randint(1, 32000, (n,), generator=g)
    pos = torch.arange(bucket, dtype=torch.int32)[None]
    sampler = (torch.tensor([seed, 0], dtype=torch.int64, device="cuda"),
               torch.tensor([0.0 if greedy else 0.7], device="cuda"),
               torch.tensor([1.0 if greedy else 0.9], device="cuda"),
               torch.tensor([0 if greedy else 40], dtype=torch.int32, device="cuda"))
    if eng._gr_on:
        allowed = torch.rand(eng.model_cfg.vocab_size, generator=g) < 0.3
        sampler += (torch.where(allowed, 0.0, -1e30).to(torch.float32).cuda(),)
    return toks.cuda(), pos.cuda(), sampler


@pytest.mark.cuda
@pytest.mark.parametrize("name,fields", [
    ("mistral-4l", dict()),
    ("mistral-4l", dict(grammar=True, grammar_max_states=8)),
    ("mistral-4l", dict(kv_quant="int8")),
    ("mixtral-2l", dict(num_slots=8)),
])
def test_cuda_replayed_prefill_equals_the_eager_program(name, fields):
    """Every bucket, greedy and sampled: the replay gives the first token,
    the new key data and the slot's KV rows that the eager
    ``prefill_insert`` gives on a copy of the same state, bit for bit,
    and leaves every other slot's rows as they were."""
    needs_card()
    eng = _engine(name, **fields)
    graphs = eng._prefill_graphs()
    assert sorted(graphs.capture_s) == list(eng.cfg.usable_buckets())
    print(f"\n{name} {fields}: capture s {graphs.capture_s}, pool "
          f"{graphs.pool_bytes / 1e9:.3f} GB")
    for i, bucket in enumerate(eng.cfg.usable_buckets()):
        for greedy in (True, False):
            slot, n = 3 + i, bucket - 7 - i
            toks, pos, sampler = _operands(eng, bucket, n, greedy, seed=i * 2 + greedy)
            ck, cv = _clone(eng._ck), _clone(eng._cv)
            want = eng._prefill_program(eng.params, ck, cv, toks, pos, slot, n - 1, *sampler)
            before = (_clone(eng._ck), _clone(eng._cv))
            replays = eng.metrics["prefill_graph_replays"]
            got = eng._prefill_insert_fn(eng.params, eng._ck, eng._cv, toks, pos, slot, n - 1,
                                         *sampler)
            torch.cuda.synchronize()
            assert eng.metrics["prefill_graph_replays"] == replays + 1
            assert int(got[0]) == int(want[0]) and torch.equal(got[1], want[1])
            others = [s for s in range(eng.cfg.num_slots) if s != slot]
            for live, eager, old in zip((eng._ck, eng._cv), (ck, cv), before):
                for a, b, o in zip(_leaves(live), _leaves(eager), _leaves(old)):
                    err = (a.float() - b.float()).abs().max().item()
                    assert torch.equal(a, b), f"bucket {bucket}: max abs error {err}"
                    assert torch.equal(a[:, others], o[:, others])


@pytest.mark.cuda
def test_cuda_a_call_on_another_state_runs_the_eager_program():
    """A call whose caches are not the ones the graphs captured (warmup's
    scratch, a copy) runs the eager program into them and replays
    nothing."""
    needs_card()
    eng = _engine()
    eng._prefill_graphs()
    toks, pos, sampler = _operands(eng, 128, 100, greedy=True, seed=5)
    ck, cv = _clone(eng._ck), _clone(eng._cv)
    ck2, cv2 = _clone(eng._ck), _clone(eng._cv)
    got = eng._prefill_insert_fn(eng.params, ck, cv, toks, pos, 7, 99, *sampler)
    want = eng._prefill_program(eng.params, ck2, cv2, toks, pos, 7, 99, *sampler)
    assert eng.metrics["prefill_graph_replays"] == 0
    assert int(got[0]) == int(want[0]) and torch.equal(ck, ck2) and torch.equal(cv, cv2)


@pytest.mark.cuda
def test_cuda_warmup_captures_and_a_reallocation_recaptures_at_the_next_placement():
    """Warmup's prefill tasks run eagerly (no replay) and its restore
    captures every bucket; ``_init_device_state`` (recovery's and
    warmup's reallocation) drops the graphs beside the ring's, and the
    next placement captures again and replays; a recovery captures them
    with the ring's."""
    needs_card()
    eng = _engine()
    eng.warmup()
    assert eng._fresh_graphs is not None and eng._ring_graphs is not None
    assert eng.metrics["prefill_graph_replays"] == 0
    eng._init_device_state()
    assert eng._fresh_graphs is None and eng._ring_graphs is None
    _serve(eng, _prompts(3, 4))
    assert eng._fresh_graphs is not None
    assert eng.metrics["prefill_graph_replays"] == eng.metrics["prefill_steps"] == 3
    eng._recover("a test's recovery")
    assert eng._fresh_graphs is not None and eng._fresh_graphs.ck is eng._ck
    _serve(eng, _prompts(2, 5))
    assert eng.metrics["prefill_graph_replays"] == eng.metrics["prefill_steps"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mistral-4l", "mixtral-2l"])
def test_cuda_every_fresh_placement_replays_and_serves_the_eager_engines_tokens(name):
    """A warmed ring engine serves 24 prompts of 20-250 tokens (buckets 64
    to 256), half sampled, with ``prefill_graph_replays`` equal to the
    fresh prefills placed, and the tokens of the same engine kept on the
    eager prefill."""
    needs_card()
    prompts = _prompts(24, 6)
    eager = _engine(name, num_slots=8)
    eager._prefill_graphs_engage = lambda: False
    eager.warmup()
    want = _serve(eager, prompts)
    assert eager.metrics["prefill_graph_replays"] == 0
    del eager
    eng = _engine(name, num_slots=8)
    eng.warmup()
    assert _serve(eng, prompts) == want
    assert eng.metrics["prefill_graph_replays"] == eng.metrics["prefill_steps"] == 24


@pytest.mark.cuda
def test_cuda_the_benchmarks_wrapper_times_each_replayed_prefill():
    """``portbench.tracing.Spans`` wraps ``_prefill_insert_fn`` as before:
    one ``prefill`` span per placement, each with a CUDA event pair around
    the replay, and the timeline's event pairs see each prefill too."""
    from portbench.tracing import Spans

    needs_card()
    eng = _engine(num_slots=8, flight_events=4096)
    eng.warmup()
    spans = Spans(eng).install()
    try:
        _serve(eng, _prompts(10, 7))
    finally:
        spans.remove()
    pre = [s for s in spans.spans if s.kind == "prefill"]
    assert len(pre) == 10 == eng.metrics["prefill_graph_replays"]
    ms = [s.device_ms() for s in pre]
    print(f"\nreplayed prefills, event ms: {[round(m, 3) for m in ms]}")
    assert all(m > 0 for m in ms)
    assert eng.metrics["decode_gap_placement_ns"] > 0
