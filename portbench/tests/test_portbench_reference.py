"""The plain reference against the port's CPU forward and engine at test
widths, and the fp8 control against a bfloat16 program."""

import numpy as np
import pytest
import torch

from omnia_tpu_torch.engine.engine import InferenceEngine
from omnia_tpu_torch.engine.types import EngineConfig, SamplingParams
from omnia_tpu_torch.models import llama
from portbench import spec, weights
from portbench.reference import model as ref
from portbench.tests.tiny import DENSE, MOE


def _layer(cfg, seed, dtype):
    return lambda i: weights.layer(cfg, seed, i, "cpu", dtype)


def _reference(cfg, seed, seqs, wanted, precision="f32", dtype=torch.float32):
    return ref.logits_at(_layer(cfg, seed, dtype), weights.globals_(cfg, seed, "cpu", dtype),
                         cfg, seqs, wanted, precision, "cpu")


# Drawn at the usual 0.02 scale, the router is near uniform and the
# capacity dispatch of 80 rows drops no token (the reference has no
# capacity); the tiny cell's larger scale skews it into drops.
MOE_FORWARD = dict(MOE, initializer_range=0.02)


@pytest.mark.parametrize("cfg,T", [(DENSE, 24), (MOE_FORWARD, 16), (MOE_FORWARD, 80)],
                         ids=["dense", "moe-all-experts", "moe-dispatch"])
def test_reference_logits_equal_the_ports_forward(cfg, T):
    seed = 2**31 + 7
    params = weights.draw(cfg, seed, "cpu", torch.float32)
    # The stacked tree holds each layer exactly as the reference draws it.
    assert torch.equal(params["layers"]["attn"]["wq"][1],
                       weights.layer(cfg, seed, 1, "cpu", torch.float32)["attn"]["wq"])
    toks = np.random.default_rng(0).integers(0, cfg["vocab_size"], T).tolist()
    port = llama.forward_train(params, spec.model_config(cfg), torch.tensor([toks]))[0]
    mine = _reference(cfg, seed, [toks], [list(range(T))])[0]
    assert (port - mine).abs().max().item() < 2e-5 * mine.abs().max().item()


def _served(cfg, seed, prompts, n_new, dtype):
    mcfg = spec.model_config(cfg)
    eng = InferenceEngine(mcfg, EngineConfig(num_slots=4, max_seq=128,
                                             prefill_buckets=(16, 32, 64), decode_ring=2,
                                             dtype="float32" if dtype == torch.float32
                                             else "bfloat16"),
                          params=weights.draw(cfg, seed, "cpu", dtype), device="cpu")
    handles = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=n_new)) for p in prompts]
    while eng.step():
        pass
    return [h.collect_tokens(timeout=60)[0] for h in handles]


def _gaps(cfg, seed, prompts, served):
    seqs = [p + s[:-1] for p, s in zip(prompts, served)]
    wanted = [list(range(len(p) - 1, len(p) - 1 + len(s))) for p, s in zip(prompts, served)]
    f32 = _reference(cfg, seed, seqs, wanted)
    low = _reference(cfg, seed, seqs, wanted, "fp8")
    program = max(ref.gaps(lg, torch.tensor(s)).max().item() for lg, s in zip(f32, served))
    control = max(ref.gaps(lg, lo.argmax(-1)).max().item() for lg, lo in zip(f32, low))
    return program, control


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (9, 30, 17, 50)]


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_greedy_tokens_of_the_ports_engine_are_the_references_best(cfg):
    seed = 11
    prompts = _prompts(cfg, seed)
    served = _served(cfg, seed, prompts, 12, torch.float32)
    program, _ = _gaps(cfg, seed, prompts, served)
    assert program < 1e-4


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_reads_past_a_bfloat16_program(seed):
    """The control at a size a test holds: over the same prompts and
    served tokens, the token fp8 operands put first lies further below
    the reference's best than any token the bf16 engine served, and past
    the tiny configuration's limit."""
    prompts = _prompts(DENSE, seed)
    served = _served(DENSE, seed, prompts, 24, torch.bfloat16)
    program, control = _gaps(DENSE, seed, prompts, served)
    assert program <= DENSE["check"]["widest_gap"] < control


@pytest.mark.parametrize("V,t,p,k,scale", [(256, 0.7, 0.9, 40, 3.0), (1000, 0.7, 0.9, 40, 3.0),
                                           (1000, 1.0, 0.5, 0, 3.0), (300, 0.7, 1.0, 7, 3.0),
                                           (1000, 0.7, 0.9, 0, 0.3), (1000, 0.7, 0.9, 400, 0.3)])
def test_the_references_admitted_set_is_the_ports_sampler_filter(V, t, p, k, scale):
    """The set of tokens that the check holds a sampled token to, from the
    reference's plain sort, is the set the port's sampler draws from,
    over its fast prefix path (V ≤ 256 or k ≤ 256) and its full sort
    (flat logits, whose nucleus passes 256 tokens)."""
    from omnia_tpu_torch.ops import sampling

    logits = torch.randn(64, V, generator=torch.Generator().manual_seed(V + k)) * scale
    B = logits.shape[0]
    filtered, _ = sampling._prepare(logits, torch.full((B,), t), torch.full((B,), p),
                                    torch.full((B,), k, dtype=torch.int32))
    port = filtered > sampling._NEG_INF
    mine = logits / t >= ref.admitted_floor(logits, t, p, k)[:, None]
    assert torch.equal(port, mine)
    probs = ref.sampler_probs(logits, t, p, k)
    assert torch.equal(probs > 0, mine)
    assert torch.allclose(probs.sum(-1), torch.ones(B))
