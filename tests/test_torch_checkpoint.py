"""The port's HF checkpoint I/O (``omnia_tpu_torch/models/checkpoint.py``)
and provider builder (``omnia_tpu_torch/runtime/providers.py``) held
against the JAX package on the CPU (oracle: tests/test_checkpoint.py):
checkpoints written by the JAX ``save_params`` load to trees bit-identical
to the JAX ``load_params``' (f32 and bf16, single file and sharded,
quant None / int8 / int8-dynamic), llama and mixtral; the port's
``save_params`` reads back through the JAX loader bit for bit; the port's
safetensors reader agrees with the ``safetensors`` package; logits from
a ``transformers`` llama and mixtral match within 1e-5; and
``build_engine`` serves the JAX builder's greedy tokens."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.coldstart import ColdStartTracker
from omnia_tpu.models import checkpoint as jck
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.runtime import providers as jproviders
from omnia_tpu_torch.engine import SamplingParams
from omnia_tpu_torch.models import checkpoint as tck
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.runtime import providers as tproviders

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def manifest_dir(tmp_path_factory):
    """Every engine here keeps its warmup manifests in a directory of the
    test run's own, never in the package's build cache."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        d = tmp_path_factory.mktemp("manifests")
        monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(d))
        yield d


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(port, ref, path=""):
    """Every leaf of a port tree equal, dtype and bits, to a numpy tree."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_trees_equal(port[k], ref[k], f"{path}/{k}")
        return
    if ref.dtype.name == "bfloat16":
        assert port.dtype == torch.bfloat16, path
        port = port.view(torch.int16)
    assert port.numpy().dtype == _bits(ref).dtype, path
    np.testing.assert_array_equal(port.numpy(), _bits(ref), err_msg=path)


def _jax_checkpoint(path, dtype="float32", sharded=False, seed=7, cfg=None):
    cfg = cfg or jget_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.key(seed), dtype=JDTYPES[dtype])
    kw = dict(max_shard_bytes=64 * 1024) if sharded else {}
    jck.save_params(params, cfg, str(path), **kw)
    return cfg, params


# ---------------------------------------------------------------------------
# Loading against the JAX loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8", "int8-dynamic"])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_load_bit_identical_to_jax(tmp_path, dtype, sharded, quant):
    cfg, _ = _jax_checkpoint(tmp_path, dtype, sharded)
    assert os.path.exists(tmp_path / ("model.safetensors.index.json" if sharded
                                      else "model.safetensors"))
    want = _np_tree(jck.load_params(str(tmp_path), cfg, dtype=JDTYPES[dtype], quant=quant))
    got = tck.load_params(str(tmp_path), get_config("test-tiny"), dtype=TDTYPES[dtype],
                          device="cpu", quant=quant)
    _assert_trees_equal(got, want)


def test_load_casts_to_the_target_dtype_and_reads_config(tmp_path):
    """A f32 checkpoint loaded at bf16 rounds as the JAX loader does; with
    no cfg the loader reads config.json."""
    _jax_checkpoint(tmp_path, "float32")
    want = _np_tree(jck.load_params(str(tmp_path), dtype=jnp.bfloat16))
    _assert_trees_equal(tck.load_params(str(tmp_path), dtype=torch.bfloat16, device="cpu"),
                        want)


def test_progress_feed_matches_jax(tmp_path):
    cfg, _ = _jax_checkpoint(tmp_path)
    jfeed, tfeed = [], []
    jck.load_params(str(tmp_path), cfg, dtype=jnp.bfloat16,
                    progress_cb=lambda a, b: jfeed.append((a, b)))
    tck.load_params(str(tmp_path), get_config("test-tiny"), device="cpu",
                    progress_cb=lambda a, b: tfeed.append((a, b)))
    assert tfeed == jfeed and tfeed[-1][0] == tfeed[-1][1]
    assert tck.expected_param_bytes(get_config("test-tiny"), torch.float32) == \
        jck.expected_param_bytes(cfg, jnp.float32)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_port_save_reads_back_through_jax(tmp_path, dtype, sharded):
    cfg = jget_config("test-tiny")
    jparams = jllama.init_params(cfg, jax.random.key(3), dtype=JDTYPES[dtype])
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    kw = dict(max_shard_bytes=64 * 1024) if sharded else {}
    tck.save_params(tparams, get_config("test-tiny"), str(tmp_path), **kw)
    assert os.path.exists(tmp_path / "model.safetensors.index.json") is sharded
    back = jck.load_params(str(tmp_path), dtype=JDTYPES[dtype])
    for a, b in zip(jax.tree.leaves(_np_tree(back)), jax.tree.leaves(_np_tree(jparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert jck.read_config(str(tmp_path)) == dataclasses.replace(cfg, name=tmp_path.name)


def test_save_refuses_quantized_tree_with_jax_message(tmp_path):
    from omnia_tpu.models import quant as jquant
    from omnia_tpu_torch.models import quant as tquant

    cfg = jget_config("test-tiny")
    jparams = jllama.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    with pytest.raises(jck.CheckpointError) as je:
        jck.save_params(jquant.quantize_params(jparams, cfg, "int8"), cfg, str(tmp_path / "j"))
    tq = tquant.quantize_params(params_from_jax(_np_tree(jparams), "cpu"),
                                get_config("test-tiny"), "int8")
    with pytest.raises(tck.CheckpointError) as te:
        tck.save_params(tq, get_config("test-tiny"), str(tmp_path / "t"))
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------


def test_reader_and_writer_agree_with_safetensors(tmp_path):
    """Every dtype the port handles, read from a file the safetensors
    package wrote, and read by the package from a file the port wrote."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 3)).astype(np.float32))
        .to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-128, 128, (5, 3)).astype(np.int8)),
        "odd_bf16": torch.ones(3, dtype=torch.bfloat16),
    }
    save_file(tensors, str(tmp_path / "model.safetensors"))
    reader = tck._ShardReader(str(tmp_path))
    assert reader.names() == set(tensors)
    for name, t in tensors.items():
        got = reader.get(name)
        assert got.dtype == t.dtype and torch.equal(got, t), name
    ours = tmp_path / "ours"
    ours.mkdir()
    tck.write_safetensors(str(ours / "model.safetensors"), tensors, metadata={"format": "pt"})
    with safe_open(str(ours / "model.safetensors"), framework="pt") as f:
        assert set(f.keys()) == set(tensors) and f.metadata() == {"format": "pt"}
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and torch.equal(got, t), name
    with pytest.raises(tck.CheckpointError, match="not in checkpoint"):
        reader.get("nope")


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

HF_CONFIGS = [
    dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
         num_attention_heads=4, num_key_value_heads=2, model_type="llama"),
    dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
         num_attention_heads=4, rope_theta=500000.0, rms_norm_eps=1e-6,
         tie_word_embeddings=True, max_position_embeddings=256, head_dim=32,
         rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                       "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
         num_attention_heads=4, model_type="mixtral", num_local_experts=4,
         rope_scaling={"type": "default"}),
]


@pytest.mark.parametrize("d", HF_CONFIGS)
def test_config_matches_jax(d, tmp_path):
    tcfg, jcfg = tck.hf_config_to_model(d), jck.hf_config_to_model(d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tck.model_to_hf_config(tcfg) == jck.model_to_hf_config(jcfg)
    assert tck.hf_config_to_model(tck.model_to_hf_config(tcfg)) == tcfg
    with open(tmp_path / "config.json", "w") as f:
        json.dump(d, f)
    assert dataclasses.asdict(tck.read_config(str(tmp_path), name="x")) == \
        dataclasses.asdict(jck.read_config(str(tmp_path), name="x"))


def test_presets_round_trip_like_jax():
    for name in ("llama3-8b", "llama3-70b", "llama3-1b"):
        hf = tck.model_to_hf_config(get_config(name))
        assert hf == jck.model_to_hf_config(jget_config(name))
        assert tck.hf_config_to_model(hf, name=name) == get_config(name)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def _same_error(port_call, jax_call):
    with pytest.raises(jck.CheckpointError) as je:
        jax_call()
    with pytest.raises(tck.CheckpointError) as te:
        port_call()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["missing_dir", "missing_tensor", "shape", "config_field",
                                  "rope_scaling", "model_type", "rope_field", "no_files"])
def test_errors_match_jax(tmp_path, case):
    if case in ("missing_tensor", "shape"):
        cfg, _ = _jax_checkpoint(tmp_path)
        change = dict(num_layers=3) if case == "missing_tensor" else dict(hidden_size=128)
        _same_error(
            lambda: tck.load_params(str(tmp_path), dataclasses.replace(get_config("test-tiny"),
                                                                       **change),
                                    dtype=torch.float32, device="cpu"),
            lambda: jck.load_params(str(tmp_path), dataclasses.replace(cfg, **change),
                                    dtype=jnp.float32))
        return
    if case == "no_files":
        _same_error(lambda: tck._ShardReader(str(tmp_path)),
                    lambda: jck._ShardReader(str(tmp_path)))
        return
    if case == "missing_dir":
        _same_error(lambda: tck.read_config(str(tmp_path / "nope")),
                    lambda: jck.read_config(str(tmp_path / "nope")))
        return
    d = {
        "config_field": {"hidden_size": 64},
        "rope_scaling": dict(HF_CONFIGS[0], rope_scaling={"rope_type": "yarn", "factor": 4.0}),
        "model_type": {"model_type": "qwen2"},
        "rope_field": dict(HF_CONFIGS[0], rope_scaling={"rope_type": "llama3", "factor": 8.0}),
    }[case]
    _same_error(lambda: tck.hf_config_to_model(d), lambda: jck.hf_config_to_model(d))


def test_lm_head_fallback_ties_to_embed(tmp_path):
    """A checkpoint without lm_head (implicit tying) loads as the JAX
    loader loads it, quantized or not."""
    from safetensors import safe_open
    from safetensors.numpy import save_file

    cfg, _ = _jax_checkpoint(tmp_path)
    f = str(tmp_path / "model.safetensors")
    with safe_open(f, framework="np") as h:
        tensors = {k: h.get_tensor(k) for k in h.keys() if k != "lm_head.weight"}
    save_file(tensors, f)
    for quant in (None, "int8"):
        want = _np_tree(jck.load_params(str(tmp_path), cfg, dtype=jnp.float32, quant=quant))
        got = tck.load_params(str(tmp_path), dtype=torch.float32, device="cpu", quant=quant)
        _assert_trees_equal(got, want)
    plain = tck.load_params(str(tmp_path), dtype=torch.float32, device="cpu")
    assert torch.equal(plain["lm_head"], plain["embed"].T)


# ---------------------------------------------------------------------------
# Mixtral (MoE) checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_moe_load_bit_identical_to_jax(tmp_path, dtype, sharded, quant):
    """A JAX-written test-tiny-moe checkpoint: the router [L, D, E] and
    the stacked experts [L, E, ...] equal the JAX loader's bit for bit;
    with quant the attention and lm_head quantize, the MoE MLP does not."""
    cfg, _ = _jax_checkpoint(tmp_path, dtype, sharded, cfg=jget_config("test-tiny-moe"))
    want = _np_tree(jck.load_params(str(tmp_path), cfg, dtype=JDTYPES[dtype], quant=quant))
    got = tck.load_params(str(tmp_path), dtype=TDTYPES[dtype], device="cpu", quant=quant)
    _assert_trees_equal(got, want)
    mlp = got["layers"]["mlp"]
    assert mlp["router"].shape == (cfg.num_layers, cfg.hidden_size, cfg.num_experts)
    assert all(isinstance(v, torch.Tensor) for v in mlp.values())
    assert isinstance(got["layers"]["attn"]["wq"], dict) is (quant is not None)


@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_moe_port_save_reads_back_through_jax(tmp_path, dtype):
    cfg = jget_config("test-tiny-moe")
    jparams = jllama.init_params(cfg, jax.random.key(4), dtype=JDTYPES[dtype])
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    tck.save_params(tparams, get_config("test-tiny-moe"), str(tmp_path),
                    max_shard_bytes=64 * 1024)
    back = jck.load_params(str(tmp_path), dtype=JDTYPES[dtype])
    for a, b in zip(jax.tree.leaves(_np_tree(back)), jax.tree.leaves(_np_tree(jparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert jck.read_config(str(tmp_path)) == dataclasses.replace(cfg, name=tmp_path.name)
    assert tck.expected_param_bytes(get_config("test-tiny-moe"), TDTYPES[dtype]) == \
        jck.expected_param_bytes(cfg, JDTYPES[dtype])


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rope_scaling", [None, "llama3"])
def test_logits_match_transformers(tmp_path, rope_scaling):
    """A transformers LlamaForCausalLM saved with save_pretrained: the
    port's prefill logits agree to f32 round-off (long positions, past
    original_max, where the llama3 remap matters)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    extra = {}
    if rope_scaling:
        extra = dict(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 64})
    hf = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
                     max_position_embeddings=256, **extra)
    torch.manual_seed(0)
    model = LlamaForCausalLM(hf).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tck.read_config(str(tmp_path))
    assert cfg.rope_scaling == ((8.0, 1.0, 4.0, 64.0) if rope_scaling else None)
    params = tck.load_params(str(tmp_path), cfg, dtype=torch.float32, device="cpu")
    T = 96 if rope_scaling else 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, T)))
    with torch.no_grad():
        ref = model(toks).logits
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    got, _, _ = tllama.forward_prefill(params, cfg, toks, pos)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_moe_logits_match_transformers(tmp_path):
    """A transformers MixtralForCausalLM (E = 4, K = 2) saved with
    save_pretrained: the port's prefill logits at 2 x 12 rows (the
    all-expert path, which drops nothing, as transformers does not)
    agree to f32 round-off."""
    from transformers import MixtralConfig, MixtralForCausalLM

    hf = MixtralConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       num_local_experts=4, num_experts_per_tok=2, rope_theta=10000.0,
                       rms_norm_eps=1e-5, tie_word_embeddings=False,
                       max_position_embeddings=256, router_jitter_noise=0.0)
    torch.manual_seed(0)
    model = MixtralForCausalLM(hf).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tck.read_config(str(tmp_path))
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (4, 2)
    params = tck.load_params(str(tmp_path), cfg, dtype=torch.float32, device="cpu")
    T = 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, T)))
    with torch.no_grad():
        ref = model(toks).logits
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    got, _, _ = tllama.forward_prefill(params, cfg, toks, pos)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Provider builder
# ---------------------------------------------------------------------------


def _greedy(engine, sp_cls, prompts=((1, 2, 3), (7, 9, 11, 13, 200), tuple(range(40, 60)))):
    handles = [engine.submit(list(p), sp_cls(temperature=0.0, max_tokens=6)) for p in prompts]
    while engine.step():
        pass
    return [h.collect_tokens(timeout=10)[0] for h in handles]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_build_engine_from_checkpoint_matches_jax(tmp_path, quant):
    _, params = _jax_checkpoint(tmp_path, seed=11)
    options = {"checkpoint_path": str(tmp_path), "num_slots": 2, "max_seq": 64,
               "prefill_buckets": [32], "dtype": "float32", "quant": quant, "seed": 3,
               "max_sessions": 0}
    jspec = jproviders.ProviderSpec(name="real", type="tpu", model="tiny-ckpt",
                                    options=options)
    tspec = tproviders.ProviderSpec.from_dict(dataclasses.asdict(jspec))
    jeng = jproviders.build_engine(jspec)
    teng = tproviders.build_engine(tspec, warmup=True, device="cpu")
    assert teng.model_cfg == dataclasses.replace(get_config("test-tiny"), name="tiny-ckpt")
    _assert_trees_equal(teng.params, _np_tree(jeng.params))
    assert _greedy(teng, SamplingParams) == _greedy(jeng, JSamplingParams)


def test_build_engine_from_moe_checkpoint_matches_jax(tmp_path):
    _, params = _jax_checkpoint(tmp_path, seed=12, cfg=jget_config("test-tiny-moe"))
    options = {"checkpoint_path": str(tmp_path), "num_slots": 2, "max_seq": 128,
               "prefill_buckets": [16, 64], "dtype": "float32", "seed": 3,
               "max_sessions": 0}
    jspec = jproviders.ProviderSpec(name="moe", type="tpu", model="tiny-moe-ckpt",
                                    options=options)
    tspec = tproviders.ProviderSpec.from_dict(dataclasses.asdict(jspec))
    jeng = jproviders.build_engine(jspec)
    teng = tproviders.build_engine(tspec, device="cpu")
    assert teng.model_cfg == dataclasses.replace(get_config("test-tiny-moe"),
                                                 name="tiny-moe-ckpt")
    _assert_trees_equal(teng.params, _np_tree(jeng.params))
    prompts = ((1, 2, 3), tuple(range(40, 60)), tuple(range(100, 170)))
    assert _greedy(teng, SamplingParams, prompts) == _greedy(jeng, JSamplingParams, prompts)


def test_build_engine_from_preset_honours_seed():
    spec = tproviders.ProviderSpec(name="p", model="test-tiny",
                                   options={"num_slots": 2, "max_seq": 64, "dtype": "float32",
                                            "prefill_buckets": [16], "seed": 4,
                                            "quant": "int8-dynamic"})
    a = tproviders.build_engine(spec, device="cpu")
    b = tproviders.build_engine(spec, device="cpu")
    assert a.cfg.quant == "int8-dynamic" and a.cfg.num_slots == 2
    assert torch.equal(a.params["embed"], b.params["embed"])
    assert _greedy(a, SamplingParams) == _greedy(b, SamplingParams)


def test_provider_spec_and_errors_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tproviders.ProviderSpec)
            if f.name != "options"] == \
        [(f.name, f.default) for f in dataclasses.fields(jproviders.ProviderSpec)
         if f.name != "options"]
    for bad in ({"name": "x", "colour": "red"},):
        with pytest.raises(jproviders.ProviderError) as je:
            jproviders.ProviderSpec.from_dict(bad)
        with pytest.raises(tproviders.ProviderError) as te:
            tproviders.ProviderSpec.from_dict(bad)
        assert str(te.value) == str(je.value)
    for spec in (dict(name="x", model="no-such-model"), dict(name="x", type="nope")):
        with pytest.raises(jproviders.ProviderError) as je:
            jproviders.build_engine(jproviders.ProviderSpec(**spec))
        with pytest.raises(tproviders.ProviderError) as te:
            tproviders.build_engine(tproviders.ProviderSpec(**spec), device="cpu")
        assert str(te.value) == str(je.value)
    with pytest.raises(tproviders.ProviderError, match="mock"):
        tproviders.build_engine(tproviders.ProviderSpec(name="m", type="mock"), device="cpu")
    # A cold-start tracker (the runtime's, the JAX package's) and the
    # watchdog are taken: the tracker records the build's phases, the
    # knob reaches the engine.
    tracker = ColdStartTracker()
    tracker.begin_phase("backend_init")
    eng = tproviders.build_engine(tproviders.ProviderSpec(
        name="s", model="test-tiny", options={"watchdog_s": 5.0, "num_slots": 2,
                                              "max_seq": 64, "dtype": "float32"}),
        device="cpu", coldstart=tracker)
    assert eng.cfg.watchdog_s == 5.0 and eng._coldstart is tracker
    assert "backend_init" in tracker.phase_seconds()
