"""The decode step's device timeline on a card: region stamps captured
into the ring's IF bodies, the engine's event pairs around decode
chunks, and their place on the profiler's clock. This file imports
neither jax nor omnia_tpu (the machine with the card has neither), so
run it there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_timeline_cuda.py -q -s

Here, on a host without a card, every test skips. The served model has
Mistral-7B's widths at 4 layers, so that a step's fixed costs weigh as
little as they do at 32 (``-s`` prints the numbers PERF.md quotes)."""

from __future__ import annotations

import time

import pytest
import torch

from omnia_tpu_torch.ops import decode_attention as tda

# A chunk holds its operations when none that overlaps its interval
# sticks out of it by more than this at either end: the profiler's
# records and the anchored events have been seen to disagree by up to
# 92 us, and now and then a chunk overlaps none of them.
ALIGN_NS = 150_000
HOLD_SHARE = 0.9


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")


def _engine(flight_events: int, ring: int = 2, name: str = "mistral-4l"):
    from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
    from omnia_tpu_torch.models import ModelConfig, get_config

    if name == "mistral-4l":
        cfg = ModelConfig(name=name, vocab_size=32768, hidden_size=4096, num_layers=4,
                          num_heads=32, num_kv_heads=8, head_dim=128, ffn_hidden_size=14336,
                          rope_theta=1e6, max_seq_len=2048)
        fields = dict(num_slots=32, max_seq=1024, prefill_buckets=(64, 128, 256),
                      dtype="bfloat16")
    else:
        cfg = get_config(name)
        fields = dict(num_slots=4, max_seq=128, prefill_buckets=(16, 32), dtype="float32")
    return InferenceEngine(cfg, EngineConfig(decode_ring=ring, decode_chunk=8,
                                             decode_chunk_variants=(),
                                             flight_events=flight_events, **fields),
                           seed=0, device="cuda")


def _prompts(n: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 32000, (int(n_tok),), generator=g).tolist()
            for n_tok in torch.randint(20, 200, (n,), generator=g)]


def _serve(eng, prompts, max_tokens=40):
    from omnia_tpu_torch.engine import SamplingParams

    hs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=max_tokens + 3 * (i % 7)))
          for i, p in enumerate(prompts)]
    while eng.step():
        pass
    torch.cuda.synchronize()
    return [h.collect_tokens(timeout=120)[0] for h in hs]


def _device_line() -> str:
    return (f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


@pytest.mark.cuda
def test_cuda_stamped_ring_serves_the_unstamped_tokens():
    """A ring engine with the recorder on captures stamps into its IF
    bodies and serves the tokens of one without, with the same
    decode-attention launches; its steps' regions make up 90-100% of the
    chunks' event-pair time, and the early-out's skipped steps stamp
    nothing."""
    needs_card()
    off, on = _engine(0), _engine(4096)
    g_off, g_on = off._ring(), on._ring()
    assert g_off.stamps(8) is None and g_on.stamps(8) is not None
    assert off._timeline is None
    prompts = _prompts(40, 1)
    tda.reset_launches()
    want = _serve(off, prompts)
    launches_off = tda.launches()
    tda.reset_launches()
    m0 = dict(on.metrics)
    assert _serve(on, prompts) == want
    assert tda.launches() == launches_off
    m = {k: v - m0[k] for k, v in on.metrics.items() if isinstance(v, (int, float))}
    assert m["early_exit_steps"] > 0
    assert m["decode_timed_steps"] == m["decode_steps"] - m["early_exit_steps"]
    split = m["decode_attn_ns"] + m["decode_ffn_ns"] + m["decode_head_ns"]
    share = split / m["decode_chunk_device_ns"]
    steps = m["decode_timed_steps"]
    print(f"\n{_device_line()}: {steps} timed steps, per step attn "
          f"{m['decode_attn_ns'] / steps / 1e6:.4f} ffn {m['decode_ffn_ns'] / steps / 1e6:.4f} "
          f"head {m['decode_head_ns'] / steps / 1e6:.4f} chunk "
          f"{m['decode_chunk_device_ns'] / steps / 1e6:.4f} ms; regions {100 * share:.2f}% "
          f"of the chunks' event pairs")
    assert 0.90 <= share <= 1.0


@pytest.mark.cuda
def test_cuda_chunk_intervals_bracket_their_kernels_in_a_profiler_trace():
    """Each decode chunk's device interval (dev_t0_ns, dev_t1_ns on its
    flight event, placed on the wall clock through the anchors) against
    the device operations that overlap it in a torch.profiler trace of
    the same run, 20 s after the engine's last explicit anchor: at least
    ``HOLD_SHARE`` of the chunks overlap some, none of which sticks out
    of the chunk by more than ``ALIGN_NS`` at either end, so the anchors
    put the chunks on the profiler's clock (a wrong clock or drift would
    show by milliseconds in every chunk).
    The interval is the stream's: it starts before the first of them by
    the host's enqueue of the deadline copy and the graph's launch where
    the card was idle, and ends after the last where the host recorded
    the end event late (printed, not bounded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    needs_card()
    eng = _engine(4096)
    eng._ring()
    _serve(eng, _prompts(8, 2), max_tokens=8)          # every shape once
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)            # CUPTI's set-up
        torch.cuda.synchronize()
    eng._timeline.anchor()
    time.sleep(20.0)
    wall0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _serve(eng, _prompts(40, 3))
    ops = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    chunks = [e.attrs for e in eng._flight.events("decode_chunk")
              if e.attrs["dev_t0_ns"] > wall0 and e.attrs["steps_ran"] > 0]
    assert len(chunks) > 20 and ops
    heads, tails, held = [], [], 0
    for a in chunks:
        t0, t1 = a["dev_t0_ns"], a["dev_t1_ns"]
        inside = [(s, e) for s, e in ops if s < t1 and e > t0]
        if not inside:
            continue
        heads.append(min(s for s, _ in inside) - t0)
        tails.append(t1 - max(e for _, e in inside))
        held += heads[-1] >= -ALIGN_NS and tails[-1] >= -ALIGN_NS
    heads.sort()
    tails.sort()
    print(f"\n{_device_line()}: {len(chunks)} chunks; first kernel - dev_t0 "
          f"{heads[0] / 1e3:.1f} / {heads[len(heads) // 2] / 1e3:.1f} / "
          f"{heads[-1] / 1e3:.1f} us, "
          f"dev_t1 - last kernel {tails[0] / 1e3:.1f} / {tails[len(tails) // 2] / 1e3:.1f} / "
          f"{tails[-1] / 1e3:.1f} us (min / median / max); {held} hold their operations")
    assert held >= HOLD_SHARE * len(chunks)


@pytest.mark.cuda
def test_cuda_eager_chunk_stamps_every_step():
    """Ring off on the card: the eager chunk launches its stamps on the
    engine's stream, and every decode step is timed."""
    needs_card()
    eng = _engine(4096, ring=0, name="test-tiny-moe")
    _serve(eng, [[1, 2, 3], [4, 5, 6, 7], [9] * 12], max_tokens=12)
    m = eng.metrics
    assert m["decode_timed_steps"] == m["decode_steps"] > 0
    assert 0 < m["decode_moe_route_ns"] < m["decode_ffn_ns"]
    assert m["decode_attn_ns"] + m["decode_ffn_ns"] + m["decode_head_ns"] \
        < m["decode_chunk_device_ns"]
