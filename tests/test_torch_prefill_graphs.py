"""The captured fresh prefill's CPU side (``omnia_tpu_torch/engine/
prefill_graphs.py``): the program body a graph records, with the slot and
the last row as device indices, against the eager program's ints; where
the graphs engage; the engines that keep the eager program; the
benchmark's ``prefill_graph_share`` reader. The captures and replays run
only on a card: ``tests/test_torch_prefill_graphs_cuda.py``."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.programs import build_programs
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.models.kv_quant import QuantKV, kv_map
from omnia_tpu_torch.ops.sampling import make_slot_key_data

ROOT = Path(__file__).resolve().parents[1]
SLOTS, ROWS = 4, 96


@pytest.fixture(scope="module", autouse=True)
def manifest_dir(tmp_path_factory):
    """Every engine here keeps its warmup manifests in a directory of the
    test run's own, never in the package's build cache."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        d = tmp_path_factory.mktemp("manifests")
        monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(d))
        yield d


def _filled_cache(cfg, dtype, kv_quant, gen):
    """A cache whose every row holds random values, so that a write to a
    wrong row shows."""
    ck, cv = llama.init_kv_cache(cfg, SLOTS, ROWS, "cpu", dtype=dtype, kv_quant=kv_quant)
    for c in (ck, cv):
        if isinstance(c, QuantKV):
            c.q.copy_(torch.randint(-127, 128, c.q.shape, generator=gen, dtype=torch.int8))
            c.s.copy_(torch.rand(c.s.shape, generator=gen))
        else:
            c.copy_(torch.randn(c.shape, generator=gen).to(dtype))
    return ck, cv


def _clone(c):
    return kv_map(lambda a: a.clone(), c)


def _equal(a, b) -> bool:
    if isinstance(a, QuantKV):
        return torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    return torch.equal(a, b)


@pytest.mark.parametrize("model,dtype,kv_quant,grammar,bucket", [
    ("test-tiny", torch.float32, None, False, 16),
    ("test-tiny", torch.bfloat16, None, True, 32),
    ("test-tiny", torch.float32, "int8", False, 64),
    ("test-tiny-moe", torch.float32, None, False, 64),
    ("test-tiny-moe", torch.bfloat16, "int8", True, 16),
])
def test_device_indexed_prefill_writes_and_samples_what_the_int_one_does(
        model, dtype, kv_quant, grammar, bucket):
    """``prefill_insert`` with the slot and the last row as device indices
    (what a captured graph records) against the same program with ints,
    on copies of one filled cache: the same first token and key data, the
    slot's rows [0, bucket) written with the same values, every other row
    of every slot untouched; greedy and sampled (T 0.7, top-p 0.9, top-k
    40), with a grammar's start-state bias where grammar is on. The MoE
    at 64 rows runs the capacity dispatch."""
    cfg = get_config(model)
    gen = torch.Generator().manual_seed(7)
    params = llama.init_params(cfg, gen, "cpu", dtype=dtype)
    progs = build_programs(cfg, EngineConfig(num_slots=SLOTS, max_seq=ROWS,
                                             prefill_buckets=(16, 32, 64), dtype="float32",
                                             decode_ring=2, kv_quant=kv_quant))
    ck, cv = _filled_cache(cfg, dtype, kv_quant, gen)
    slot, n = 2, bucket - 5
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
    pos = torch.arange(bucket, dtype=torch.int32)[None]
    bias = ()
    if grammar:
        allowed = torch.rand(cfg.vocab_size, generator=gen) < 0.3
        bias = (torch.where(allowed, 0.0, -1e30).to(torch.float32),)
    for temp, top_p, top_k in ((0.0, 1.0, 0), (0.7, 0.9, 40)):
        sampler = (make_slot_key_data(11), torch.tensor([temp]), torch.tensor([top_p]),
                   torch.tensor([top_k], dtype=torch.int32)) + bias
        k_int, v_int = _clone(ck), _clone(cv)
        k_dev, v_dev = _clone(ck), _clone(cv)
        want = progs.prefill_insert(params, k_int, v_int, toks, pos, slot, n - 1, *sampler)
        got = progs.prefill_insert(params, k_dev, v_dev, toks, pos,
                                   torch.tensor([slot]), torch.tensor([n - 1]), *sampler)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0].shape == () and got[1].shape == (2,)
        assert _equal(k_dev, k_int) and _equal(v_dev, v_int)
        for written, before in ((k_dev, ck), (v_dev, cv)):
            rows = kv_map(lambda a: a[:, slot, :bucket], written)
            assert not _equal(rows, kv_map(lambda a: a[:, slot, :bucket], before))
            others = [s for s in range(SLOTS) if s != slot]
            assert _equal(kv_map(lambda a: a[:, others], written),
                          kv_map(lambda a: a[:, others], before))
            assert _equal(kv_map(lambda a: a[:, slot, bucket:], written),
                          kv_map(lambda a: a[:, slot, bucket:], before))


def _engine(**fields):
    fields = dict(dict(num_slots=4, max_seq=128, prefill_buckets=(16, 32), dtype="float32",
                       decode_ring=2, decode_chunk=4, decode_chunk_variants=()), **fields)
    return InferenceEngine(get_config("test-tiny"), EngineConfig(**fields), seed=0,
                           device="cpu")


@pytest.mark.parametrize("ring", [0, 2])
def test_cpu_and_ring_off_engines_capture_no_prefill_graphs(ring):
    """On the CPU, ring on or off, every fresh prefill runs the eager
    program: no graph is made, ``prefill_graph_replays`` stays 0 while
    ``prefill_steps`` counts the placements."""
    eng = _engine(decode_ring=ring)
    eng.warmup()
    hs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=4))
          for p in ([1, 2, 3], [9] * 20, list(range(30, 60)))]
    while eng.step():
        pass
    assert all(h.collect_tokens(timeout=60)[0] for h in hs)
    assert eng._prefill_graphs() is None and eng._fresh_graphs is None
    assert eng.metrics["prefill_steps"] == 3
    assert eng.metrics["prefill_graph_replays"] == 0


@pytest.mark.parametrize("fields,mesh,engage", [
    (dict(decode_ring=2), False, True),
    (dict(decode_ring=2, kv_quant="int8"), False, True),
    (dict(decode_ring=0), False, False),
    (dict(decode_ring=2, kv_pages=33, kv_page_tokens=16), False, False),
    (dict(decode_ring=2), True, False),
])
def test_prefill_graphs_engage_on_one_rank_ring_engines_over_a_contiguous_cache(
        fields, mesh, engage):
    """The condition on state the engine can observe: the ring on, the
    card, one rank (no tp, dp or sp communicator), a contiguous cache.
    The device and the mesh are stood in for after construction (the
    predicate reads them alone); on the CPU itself nothing engages."""
    eng = _engine(**fields)
    assert not eng._prefill_graphs_engage()
    eng.device = torch.device("cuda")
    if mesh:
        eng._mesh = object()
    assert eng._prefill_graphs_engage() is engage


def _share(run):
    from portbench import spec

    return spec.reader(ROOT, "prefill_graph_share")(run)


def _run(open_, close):
    return SimpleNamespace(counters={"open": open_, "close": close},
                           delta=lambda name: close[name] - open_[name])


@pytest.mark.parametrize("open_,close,want", [
    (dict(prefill_steps=3, prefill_graph_replays=3),
     dict(prefill_steps=40, prefill_graph_replays=40), 100.0),
    (dict(prefill_steps=0, prefill_graph_replays=0),
     dict(prefill_steps=8, prefill_graph_replays=2), 25.0),
    (dict(prefill_steps=5, prefill_graph_replays=5),
     dict(prefill_steps=5, prefill_graph_replays=5), None),
    (dict(prefill_steps=0), dict(prefill_steps=12), None),
])
def test_prefill_graph_share_reads_the_replayed_share_of_the_windows_placements(
        open_, close, want):
    """``portbench/metrics/prefill_graph_share.py`` on a stand-in run: the
    % of the window's placements that replayed a graph; None where none
    was placed, and None where the engine keeps no such counter (the
    parent's), not a KeyError."""
    assert _share(_run(open_, close)) == want
