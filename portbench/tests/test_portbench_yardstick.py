"""The benchmark's arithmetic, computed by hand at tiny sizes: tails,
tokens per second, occupancy, model FLOPs and K1's bytes."""

import types

import pytest

from portbench import spec, yardstick
from portbench.driver import Record
from portbench.run import Run
from portbench.tests.tiny import DENSE, MOE, REPO

CFG = dict(DENSE, num_hidden_layers=2, hidden_size=8, num_attention_heads=2,
           num_key_value_heads=1, intermediate_size=16, vocab_size=10)


def test_quantile_is_exact():
    assert yardstick.quantile([3, 1, 2], 0.5) == 2
    assert yardstick.quantile([1, 2, 3, 4], 0.5) == 2.5
    assert yardstick.quantile(range(1, 101), 0.95) == pytest.approx(95.05)
    assert yardstick.quantile([7], 0.95) == 7


def test_flops_and_bytes_by_hand():
    # D 8, H 2, Hkv 1, Dh 4, F 16, V 10, L 2.
    attn = 8 * (2 + 2 * 1) * 4 + 2 * 4 * 8          # q, k, v, o
    mlp = 3 * 8 * 16
    assert yardstick.matmul_params_per_token(CFG) == 2 * (attn + mlp)
    assert yardstick.head_params(CFG) == 80
    # A 3-token prompt: rows see 1, 2, 3 keys; 4 FLOPs a key per head-dim a head a layer.
    causal = 4 * 2 * 2 * 4 * (1 + 2 + 3)
    assert yardstick.prefill_flops(CFG, 3) == 2 * 2 * (attn + mlp) * 3 + causal + 2 * 80
    assert yardstick.decode_flops(CFG, 5) == 2 * (2 * (attn + mlp) + 80) + 4 * 2 * 2 * 4 * 6
    # Position 5: K and V rows 0..5, q and the output row, bf16, 2 layers.
    assert yardstick.k1_bytes(CFG, 5) == 2 * (2 * 6 * 1 * 4 + 2 * 2 * 4) * 2
    moe = dict(CFG, num_local_experts=4, num_experts_per_tok=2)
    assert yardstick.matmul_params_per_token(moe) == 2 * (attn + 2 * mlp + 8 * 4)


def _run(records, counters=None):
    counters = counters or {"open": {}, "close": {}}
    return Run(CFG, {}, records, t0=10.0, t1=20.0, setup_s=4.5, counters=counters,
               num_slots=4)


def _rec(i, due, times, ended=None, prompt=3):
    r = Record(i, prompt, len(times), True, due, token_times=list(times),
               tokens=[1] * len(times), ended=ended, reason="length" if ended else None)
    return r


def read(name, run):
    return spec.reader(REPO, name)(run)


def test_end_to_end_readers_by_hand():
    recs = [_rec(0, 9.0, [9.5, 10.5, 11.5], ended=11.5),      # due before the window
            _rec(1, 10.0, [10.2, 10.4, 10.6, 10.8], ended=10.8),
            _rec(2, 15.0, [15.5, 16.5], ended=16.5),
            _rec(3, 19.0, []),                               # no first token yet
            _rec(4, 18.0, [18.3, 20.5], ended=20.5)]         # ends after the window
    run = _run(recs)
    # TTFT over requests due in [10, 20): 0.2, 0.5, 0.3 and request 3,
    # which waited to the last first token seen (18.3 < t1 = 20): 1.0.
    assert read("ttft_p95_s", run) == pytest.approx(yardstick.quantile([0.2, 0.5, 0.3, 1.0], 0.95))
    # TPOT over requests ended in the window: 1000, 200, 1000 ms.
    assert read("tpot_p95_ms", run) == pytest.approx(yardstick.quantile([1000, 200, 1000], 0.95))
    # Tokens pushed in [10, 20): 10.5, 11.5, 4 of request 1, 2 of request 2, 18.3.
    assert read("output_tokens_per_s", run) == pytest.approx(9 / 10)
    assert read("setup_s", run) == 4.5


def test_counter_readers_by_hand():
    counters = {"open": dict(tokens_generated=100, prefill_steps=10, decode_steps=50,
                             early_exit_steps=5, prefill_tokens=1000),
                "close": dict(tokens_generated=260, prefill_steps=20, decode_steps=90,
                              early_exit_steps=5, prefill_tokens=3000)}
    run = _run([], counters)
    # 150 decode tokens over 40 steps that ran x 4 slots.
    assert read("decode_occupancy", run) == pytest.approx(100 * 150 / 160)
    # Device metrics read nothing off the card.
    for name in ("decode_step_ms", "prefill_ms_per_ktok", "k1_roofline", "mfu.decode",
                 "device_idle_share.decode"):
        assert read(name, run) is None


def test_device_readers_by_hand():
    from portbench.tracing import Profile, Span

    class Pair:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    def span(kind, t0, ms):
        return Span(kind, t0, t0 + 0.001, events=(Pair(0.0), Pair(ms)))

    counters = {"open": dict(decode_steps=0, early_exit_steps=0, prefill_tokens=0),
                "close": dict(decode_steps=16, early_exit_steps=6, prefill_tokens=500)}
    spans = types.SimpleNamespace(cuda=True, spans=[], within=lambda k, a, b: {
        "_run_decode_step": [span(k, 11, 30.0), span(k, 12, 20.0)],
        "prefill": [span(k, 13, 10.0)]}[k])
    # Two decode tokens in the traced span, at positions 3 and 4.
    recs = [_rec(0, 10.0, [10.5, 12.5, 13.5], ended=13.5)]
    ns = 1_000_000_000
    prof = Profile(ns0=0, ns1=2 * ns,
                   ops=[("decode_kernel<...>", 0, ns // 2), ("gemm", ns // 4, ns)])
    run = Run(CFG, {}, recs, 10.0, 20.0, 1.0, counters, 4, spans, prof, (12.0, 14.0),
              cuda=True)
    assert read("decode_step_ms", run) == pytest.approx(50.0 / 10)
    assert read("prefill_ms_per_ktok", run) == pytest.approx(10.0 / 500 * 1000)
    need = yardstick.k1_bytes(CFG, 3) + yardstick.k1_bytes(CFG, 4)
    assert read("k1_roofline", run) == pytest.approx(100 * need / 3.35e12 / 0.5)
    assert read("device_idle_share.decode", run) == pytest.approx(50.0)
    flops = (yardstick.prefill_flops(CFG, 3) + yardstick.decode_flops(CFG, 3)
             + yardstick.decode_flops(CFG, 4))
    assert read("mfu.decode", run) == pytest.approx(100 * flops / (10 * 989e12))
    assert prof.idle_gaps([], short_ns=1) == [["host: engine thread outside a step", 1.0]]


def test_moe_config_counts_two_experts():
    assert yardstick.dims(MOE)["E"] == 8
    dense = yardstick.matmul_params_per_token(DENSE)
    moe = yardstick.matmul_params_per_token(MOE)
    assert moe - dense == 2 * (3 * 64 * 128 + 64 * 8)
