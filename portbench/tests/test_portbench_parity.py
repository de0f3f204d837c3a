"""The two real configurations and the tiny ones read as they did before
the Mistral / Mixtral shape moved out of the harness into its family
(``portbench/families/mistral.py``): the port's ``ModelConfig``, the
counts that ``mfu.decode`` and ``k1_roofline`` read, every drawn leaf
and ``check.gaps`` over fixed prompts and served tokens, to the bit.
The literals were recorded from the harness before the move."""

import hashlib
import json
import types

import pytest
import torch

from omnia_tpu_torch.models.config import ModelConfig
from portbench import check, spec, weights, yardstick
from portbench.tests.tiny import DENSE, MIX, MOE, REPO

REAL = {
    "mistral-7b-v0.3": dict(
        model_config=ModelConfig(name='mistral-7b-v0.3', vocab_size=32768, hidden_size=4096,
                                 num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
                                 ffn_hidden_size=14336, rope_theta=1000000.0, rope_scaling=None,
                                 rms_norm_eps=1e-05, tie_embeddings=False, num_experts=0,
                                 num_experts_per_tok=2, max_seq_len=32768),
        matmul_params_per_token=6979321856, head_params=134217728,
        prefill_flops={64: 894712152064.0, 1000: 14221318291456.0, 4096: 61573993332736.0},
        decode_flops={0: 14227603456.0, 255: 14361296896.0, 2047: 15300820992.0},
        k1_bytes={0: 655360, 255: 34078720, 2047: 268959744}),
    "mixtral-8x7b-16l": dict(
        model_config=ModelConfig(name='mixtral-8x7b-16l', vocab_size=32000, hidden_size=4096,
                                 num_layers=16, num_heads=32, num_kv_heads=8, head_dim=128,
                                 ffn_hidden_size=14336, rope_theta=1000000.0, rope_scaling=None,
                                 rms_norm_eps=1e-05, tie_embeddings=False, num_experts=8,
                                 num_experts_per_tok=2, max_seq_len=32768),
        matmul_params_per_token=6308757504, head_params=131072000,
        prefill_flops={64: 808328364032.0, 1000: 12748980224000.0, 4096: 53881163743232.0},
        decode_flops={0: 12879921152.0, 255: 12946767872.0, 2047: 13416529920.0},
        k1_bytes={0: 327680, 255: 17039360, 2047: 134479872}),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_the_real_configurations_count_as_before(name):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    want = REAL[name]
    assert spec.model_config(cfg) == want["model_config"]
    assert yardstick.matmul_params_per_token(cfg) == want["matmul_params_per_token"]
    assert yardstick.head_params(cfg) == want["head_params"]
    assert {n: yardstick.prefill_flops(cfg, n) for n in (64, 1000, 4096)} == want["prefill_flops"]
    for position in (0, 255, 2047):
        assert yardstick.decode_flops(cfg, position) == want["decode_flops"][position]
        assert yardstick.k1_bytes(cfg, position) == want["k1_bytes"][position]
        assert yardstick.decode_attention_bytes(cfg, position) == want["k1_bytes"][position]


SEED = 2**31 + 12345

# sha256 of each leaf of the tree drawn in bfloat16, its first 16 hex digits.
WEIGHTS = {
    "tiny-dense": {'embed': 'd314ae4421308216',
     'layers.ln1': 'dd3ec68f1868fd75',
     'layers.ln2': 'b8f5fce4099d0b44',
     'layers.attn.wq': 'c6a36e86aaacd752',
     'layers.attn.wk': '319b1515fd445dfe',
     'layers.attn.wv': '4500faa2f5f54ecb',
     'layers.attn.wo': '02f8fc1298668990',
     'layers.mlp.wg': '313fb54beb9c870d',
     'layers.mlp.wu': 'c87d1d6b523acbc5',
     'layers.mlp.wd': '6ba0a8a68f11a0ad',
     'final_norm': 'd2c8adaa40c6d5ef',
     'lm_head': 'f2d402a3d7f83df7'},
    "tiny-moe": {'embed': '856486186b7cbf8a',
     'layers.ln1': 'dd3ec68f1868fd75',
     'layers.ln2': 'b8f5fce4099d0b44',
     'layers.attn.wq': '57601b6f135e92ff',
     'layers.attn.wk': '626ab0ad3dda0a5f',
     'layers.attn.wv': '1d595cb6b04d0269',
     'layers.attn.wo': '0b35669822e76054',
     'layers.mlp.router': '72e7fd667a065c54',
     'layers.mlp.wg': 'c3de8123c0a5e7f8',
     'layers.mlp.wu': '04788bc729051f95',
     'layers.mlp.wd': '5aa50fafa64e96c0',
     'final_norm': 'd2c8adaa40c6d5ef',
     'lm_head': 'c9064df01772edcf'},
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_the_tiny_weights_are_drawn_as_before(cfg):
    tree = weights.draw(cfg, SEED, "cpu", torch.bfloat16)
    got = {path: hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
           for path, t in _leaves(tree)}
    assert got == WEIGHTS[cfg["name"]]


# Request index → prompt, and each request's served tokens: two greedy
# requests, then two sampled ones.
PROMPTS = [[207, 21, 45, 60, 46, 205, 222, 149, 10],
           [40, 177, 188, 8, 29, 115, 100, 227, 132, 107, 110, 170, 150, 44, 188, 193, 244, 201,
            72, 81, 166, 166, 178],
           [169, 149, 62, 120, 48, 197, 121, 7, 65, 180, 133, 95, 64, 23],
           [53, 155, 161, 63, 76, 124, 189, 74, 184, 167, 55, 99, 212, 215, 168, 1, 174, 57, 209,
            233, 109, 244, 194, 83, 224, 98, 26, 151, 217, 168, 100]]
SERVED = [[24, 85, 110, 159, 122, 67], [222, 74, 240, 0, 19, 249, 241, 76, 35, 80, 11, 228],
          [155, 169, 133, 238, 237], [230, 122, 98, 37, 54, 178, 204, 74, 160]]

GAPS = {
    "tiny-dense": {'tokens_compared': 32,
     'served': {'widest_gap': 0.7629743814468384,
                'request_p25_gap': 0.3910059928894043,
                'request_median_gap': 0.4662036895751953,
                'mean_gap': 0.4234313368797302,
                'median_gap': 0.4518955945968628,
                'p90_gap': 0.6413813233375549,
                'p99_gap': 0.7434555888175964,
                'share_above_0': 0.9444444179534912,
                'per_request': [[6, 0.4243, 0.391], [12, 0.4662, 0.3028]],
                'sampled_outside_share': 0.9285714030265808,
                'sampled_widest_excess': 0.49284061789512634,
                'sampled_tokens': 14},
     'control': {'widest_gap': 0.0,
                 'request_p25_gap': 0.0,
                 'request_median_gap': 0.0,
                 'mean_gap': 0.0,
                 'median_gap': 0.0,
                 'p90_gap': 0.0,
                 'p99_gap': 0.0,
                 'share_above_0': 0.0,
                 'per_request': [[6, 0.0, 0.0], [12, 0.0, 0.0]]},
     'witness_bf16': {'widest_gap': 0.0,
                      'request_p25_gap': 0.0,
                      'request_median_gap': 0.0,
                      'mean_gap': 0.0,
                      'median_gap': 0.0,
                      'p90_gap': 0.0,
                      'p99_gap': 0.0,
                      'share_above_0': 0.0,
                      'per_request': [[6, 0.0, 0.0], [12, 0.0, 0.0]]},
     'sampler_faults': {'top_k_ignored': 0.7809573752539498,
                        'top_p_ignored': 0.08827205215181623,
                        'temperature_ignored': 0.0,
                        'unfiltered': 0.8024928910391671}},
    "tiny-moe": {'tokens_compared': 32,
     'served': {'widest_gap': 3.16569185256958,
                'request_p25_gap': 1.9922515153884888,
                'request_median_gap': 2.489043951034546,
                'mean_gap': 2.167905569076538,
                'median_gap': 2.196615695953369,
                'p90_gap': 2.8690943717956543,
                'p99_gap': 3.12074875831604,
                'share_above_0': 1.0,
                'per_request': [[6, 2.0189, 1.8833], [12, 2.489, 1.9923]],
                'sampled_outside_share': 1.0,
                'sampled_widest_excess': 3.5920517444610596,
                'sampled_tokens': 14},
     'control': {'widest_gap': 0.6345036029815674,
                 'request_p25_gap': 0.0,
                 'request_median_gap': 0.012749969959259033,
                 'mean_gap': 0.0979926660656929,
                 'median_gap': 0.0,
                 'p90_gap': 0.31740307807922363,
                 'p99_gap': 0.5867087244987488,
                 'share_above_0': 0.3333333432674408,
                 'per_request': [[6, 0.0, 0.0], [12, 0.0127, 0.0]]},
     'witness_bf16': {'widest_gap': 0.0,
                      'request_p25_gap': 0.0,
                      'request_median_gap': 0.0,
                      'mean_gap': 0.0,
                      'median_gap': 0.0,
                      'p90_gap': 0.0,
                      'p99_gap': 0.0,
                      'share_above_0': 0.0,
                      'per_request': [[6, 0.0, 0.0], [12, 0.0, 0.0]]},
     'sampler_faults': {'top_k_ignored': 0.44571982111249653,
                        'top_p_ignored': 0.09401475744588035,
                        'temperature_ignored': 0.029894399855818068,
                        'unfiltered': 0.5005672999790737}},
}


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_the_tiny_check_reads_as_before(cfg):
    recs = [types.SimpleNamespace(index=i, tokens=t) for i, t in enumerate(SERVED)]
    got = check.gaps(cfg, SEED, recs[:2], recs[2:], dict(enumerate(PROMPTS)), MIX["sampling"],
                     "cpu", torch.bfloat16, control=True)
    assert got == GAPS[cfg["name"]]
