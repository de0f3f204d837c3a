"""The port's int8 weights (``omnia_tpu_torch/models/quant.py``) held
against the JAX package's ``models/quant.py`` on the CPU (oracle:
tests/test_quant.py): quantization and W8A8 ``qdot`` bit-identical,
W8A16 ``qdot`` within rtol 1e-5 / atol 1e-6 (f32 summation order only),
``forward`` logits from a converted JAX ``quantize_params`` tree within
1e-4, and the engine's greedy streams identical to the JAX engine's
for both modes on the contiguous and on the int8 + paged KV cache."""

from __future__ import annotations

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
from omnia_tpu.models import quant as jquant
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models import quant as tquant
from omnia_tpu_torch.models.convert import params_from_jax

MODES = jquant.QUANT_MODES


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(port, ref, path=""):
    """Every leaf of a port tree equal, dtype and bits, to a numpy tree."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_trees_equal(port[k], ref[k], f"{path}/{k}")
        return
    ref = np.asarray(ref)
    if ref.dtype.name == "bfloat16":
        assert port.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(port.view(torch.int16).numpy(), ref.view(np.int16),
                                      err_msg=path)
        return
    assert port.numpy().dtype == ref.dtype, path
    np.testing.assert_array_equal(port.numpy(), ref, err_msg=path)


@pytest.fixture(scope="module")
def tiny():
    cfg = jget_config("test-tiny")
    jparams = jllama.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jparams, params_from_jax(_np_tree(jparams), "cpu")


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_identical_to_jax(mode, dtype):
    """quantize_weight and quantize_np against the JAX quantize_weight on a
    stacked [L, K, N] weight, f32 and bf16 inputs, with a zero column."""
    x = np.random.default_rng(0).standard_normal((3, 48, 40)).astype(np.float32) * 0.05
    x[1, :, 7] = 0.0
    jw = jnp.asarray(x, getattr(jnp, dtype))
    want = _np_tree(jquant.quantize_weight(jw, mode))
    tw = torch.from_numpy(x).to(getattr(torch, dtype))
    _assert_trees_equal(tquant.quantize_weight(tw, mode), want)
    got_np = tquant.quantize_np(np.asarray(jw), mode)
    for k in want:
        np.testing.assert_array_equal(got_np[k], want[k])
        assert got_np[k].dtype == want[k].dtype


def test_w8a8_weights_are_column_major(tiny):
    """The W8A8 int8 values sit column-major (the layout cuBLASLt's int8
    GEMM takes at every shape) wherever a tree is made: quantized here,
    born quantized, or converted from the JAX package; W8A16 values stay
    row-major."""
    cfg, jparams, tparams = tiny
    made = {
        "quantize_params": tquant.quantize_params(tparams, get_config("test-tiny"),
                                                  "int8-dynamic"),
        "init_params_quantized": tquant.init_params_quantized(
            get_config("test-tiny"), torch.Generator().manual_seed(0), "cpu", "int8-dynamic"),
        "params_from_jax": params_from_jax(
            _np_tree(jquant.quantize_params(jparams, cfg, "int8-dynamic")), "cpu"),
    }
    for how, tree in made.items():
        for w in list(tree["layers"]["attn"].values()) + [tree["lm_head"]]:
            assert w["w8d"].stride(-2) == 1, how
    w8 = tquant.quantize_params(tparams, get_config("test-tiny"), "int8")["layers"]["mlp"]["wg"]
    assert w8["w8"].is_contiguous()


def test_quantize_in_column_blocks_is_one_pass(monkeypatch):
    """The block size bounds temporaries only: 3-column blocks give the
    one-pass bits."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 10))
                         .astype(np.float32))
    whole = tquant.quantize_weight(w)
    monkeypatch.setattr(tquant, "_BLOCK_ELEMENTS", 16 * 3)
    blocks = tquant.quantize_weight(w)
    assert torch.equal(whole["w8"], blocks["w8"]) and torch.equal(whole["s"], blocks["s"])


def test_quantize_params_bit_identical_to_jax(tiny):
    cfg, jparams, tparams = tiny
    for mode in MODES:
        want = _np_tree(jquant.quantize_params(jparams, cfg, mode))
        got = tquant.quantize_params(tparams, get_config("test-tiny"), mode)
        _assert_trees_equal(got, want)
        assert tquant.params_quantized(got) and tquant.detect_mode(got) == mode
    assert not tquant.params_quantized(tparams) and tquant.detect_mode(tparams) is None


def test_params_from_jax_keeps_quantized_leaves(tiny):
    """A dtype cast reaches the floating weights only: int8 values and f32
    scales of a quantized tree keep their dtypes and bits."""
    cfg, jparams, _ = tiny
    jq = _np_tree(jquant.quantize_params(jparams, cfg, "int8"))
    got = params_from_jax(jq, "cpu", torch.bfloat16)
    wq = got["layers"]["attn"]["wq"]
    assert wq["w8"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    np.testing.assert_array_equal(wq["w8"].numpy(), jq["layers"]["attn"]["wq"]["w8"])
    np.testing.assert_array_equal(wq["s"].numpy(), jq["layers"]["attn"]["wq"]["s"])
    assert got["embed"].dtype == torch.bfloat16
    assert got["layers"]["ln1"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# qdot
# ---------------------------------------------------------------------------


def _qdot_inputs(mode, dtype, shape=(2, 5, 64), n=40, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], n)) * 0.05).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), mode)
    jh = jnp.asarray(h, getattr(jnp, dtype))
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    return jh, jw, th, params_from_jax(_np_tree(jw), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 17, 40])
def test_qdot_w8a8_bit_identical_to_jax(dtype, rows):
    """Exact int32 sums, then the f32 rescale in the JAX order: equal bits,
    at row counts below and above torch._int_mm's 17-row minimum."""
    jh, jw, th, tw = _qdot_inputs("int8-dynamic", dtype, shape=(rows, 64))
    want = np.asarray(jquant.qdot(jh, jw))
    got = tquant.qdot(th, tw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_qdot_w8a16_matches_jax():
    jh, jw, th, tw = _qdot_inputs("int8", "float32")
    want = np.asarray(jquant.qdot(jh, jw))
    got = tquant.qdot(th, tw)
    assert got.shape == (2, 5, 40) and got.dtype == torch.float32
    # f32 summation order only.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_qdot_matches_dense(mode):
    """The oracle's accuracy bar: int8 round trip ~0.5% per weight
    (W8A16), plus the same again on activations (W8A8)."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 32)) * 0.05).astype(np.float32))
    ref = h @ w
    err = torch.linalg.norm(tquant.qdot(h, tquant.quantize_weight(w, mode)) - ref)
    assert err / torch.linalg.norm(ref) < (0.02 if mode == "int8" else 0.05)


def test_qdot_passthrough_dense_weight():
    h, w = torch.ones(2, 8), torch.ones(8, 4)
    assert torch.equal(tquant.qdot(h, w), h @ w)


def test_scale_commutes_with_contraction():
    """h @ (q * s) == (h @ q) * s: the W8A16 identity the design rests on."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    d = tquant.quantize_weight(torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)))
    dequant = d["w8"].float() * d["s"][None, :]
    torch.testing.assert_close(tquant.qdot(h, d), h @ dequant, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Born quantized, modes, MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_init_params_quantized_matches_jax_structure(mode):
    """Same tree, shapes, dtypes and scales as the JAX package (not the same
    draws); int8 leaves uniform in [-127, 127], so the dequantized std is
    0.02 (wo, wd: 0.02/√(2L))."""
    cfg = jget_config("test-tiny")
    want = _np_tree(jquant.init_params_quantized(cfg, jax.random.key(0), mode,
                                                 dtype=jnp.float32))
    got = tquant.init_params_quantized(get_config("test-tiny"), torch.Generator().manual_seed(0),
                                       "cpu", mode, dtype=torch.float32)
    key = "w8" if mode == "int8" else "w8d"

    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype, path
        if path.endswith("/s"):
            np.testing.assert_array_equal(g.numpy(), w)

    walk(got, want, "")
    wg = got["layers"]["mlp"]["wg"]
    assert int(wg[key].min()) == -127 and int(wg[key].max()) == 127
    std = (wg[key].float() * wg["s"][:, None, :]).std().item()
    assert abs(std - 0.02) < 0.002
    assert tquant.detect_mode(got) == mode


def test_mode_validation_and_moe_messages_match_jax():
    w = torch.zeros(8, 8)
    for port_call, jax_call in (
        (lambda: tquant.quantize_weight(w, "int4"),
         lambda: jquant.quantize_weight(jnp.zeros((8, 8)), "int4")),
        (lambda: tquant.validate_mode("int4"), lambda: jquant.validate_mode("int4")),
        (lambda: tquant.init_params_quantized(get_config("test-tiny-moe"), torch.Generator(),
                                              "cpu"),
         lambda: jquant.init_params_quantized(jget_config("test-tiny-moe"), jax.random.key(0))),
    ):
        with pytest.raises(ValueError) as je:
            jax_call()
        with pytest.raises(ValueError) as te:
            port_call()
        assert str(te.value) == str(je.value)
    assert tquant.validate_mode(None) is None and tquant.validate_mode("int8") == "int8"


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_match_jax(tiny, mode):
    """A JAX quantize_params tree, converted, gives the JAX logits (within
    1e-4, f32) through a prefill and two decode steps over the cache."""
    cfg, jparams, _ = tiny
    jq = jquant.quantize_params(jparams, cfg, mode)
    tq = params_from_jax(_np_tree(jq), "cpu")
    tcfg = get_config("test-tiny")
    B, T, S = 2, 8, 32
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jck, jcv = jllama.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    tck, tcv = tllama.init_kv_cache(tcfg, B, S, "cpu", dtype=torch.float32)
    start = np.zeros(B, np.int32)
    for _ in range(3):
        jl, jck, jcv = jllama.forward(jq, cfg, jnp.asarray(tokens), jnp.asarray(pos), jck, jcv,
                                      jnp.asarray(start))
        tl, _, _ = tllama.forward(tq, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos),
                                  tck, tcv, torch.from_numpy(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        tokens = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
        start = pos[:, -1] + 1
        pos = start[:, None].copy()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

ENGINE_FIELDS = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
                     dtype="float32")
KV = {"contiguous": {}, "int8_paged": dict(kv_quant="int8", kv_pages=20, kv_page_tokens=16)}


def _submissions():
    rng = np.random.default_rng(0)
    lengths_tokens = [(7, 10), (3, 5), (12, 9), (20, 3), (30, 40), (9, 14)]
    return [([int(t) for t in rng.integers(1, 256, n)], m) for n, m in lengths_tokens]


def _drive(engine, sp_cls):
    handles = [engine.submit(p, sp_cls(temperature=0.0, max_tokens=m))
               for p, m in _submissions()]
    while engine.step():
        pass
    out = []
    for h in handles:
        toks, fin = h.collect_tokens(timeout=5)
        out.append((toks, fin.finish_reason.value, fin.num_generated_tokens))
    return out


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("mode", MODES)
def test_engine_streams_identical_to_jax(tiny, mode, kv):
    """Both engines quantize the same f32 params themselves (quant set,
    full-precision params supplied) and serve six greedy requests on two
    slots: identical tokens, finish reasons and counts."""
    cfg, jparams, tparams = tiny
    fields = dict(ENGINE_FIELDS, quant=mode, **KV[kv])
    jeng = JEngine(cfg, JEngineConfig(**fields), params=jparams, seed=0)
    teng = InferenceEngine(get_config("test-tiny"), EngineConfig(**fields), params=tparams,
                           seed=0, device="cpu")
    assert tquant.detect_mode(teng.params) == mode
    _assert_trees_equal(teng.params, _np_tree(jeng.params))
    want = _drive(jeng, JSamplingParams)
    got = _drive(teng, SamplingParams)
    assert got == want
    assert all(r[1] in ("stop", "length") for r in got)


def test_engine_adopts_prequantized_mode_and_refuses_a_contradiction(tiny):
    cfg, jparams, _ = tiny
    tq = params_from_jax(_np_tree(jquant.quantize_params(jparams, cfg, "int8-dynamic")), "cpu")
    eng = InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS), params=tq,
                          device="cpu")
    assert tquant.detect_mode(eng.params) == "int8-dynamic" and eng.params is tq
    with pytest.raises(ValueError) as je:
        JEngine(cfg, JEngineConfig(**ENGINE_FIELDS, quant="int8"),
                params=jquant.quantize_params(jparams, cfg, "int8-dynamic"))
    with pytest.raises(ValueError) as te:
        InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS, quant="int8"),
                        params=tq, device="cpu")
    assert str(te.value) == str(je.value)


def test_engine_born_quantized_and_loader_called_once():
    """params=None with quant set draws int8 leaves from the seed; a
    callable is a loader, called once."""
    eng = InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS, quant="int8"),
                          seed=5, device="cpu")
    assert tquant.detect_mode(eng.params) == "int8"
    again = InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS, quant="int8"),
                            seed=5, device="cpu")
    assert torch.equal(eng.params["lm_head"]["w8"], again.params["lm_head"]["w8"])
    calls = []

    def loader():
        calls.append(1)
        return eng.params

    loaded = InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS),
                             params=loader, device="cpu")
    assert calls == [1] and loaded.params is eng.params
    h = loaded.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4))
    while loaded.step():
        pass
    toks, fin = h.collect_tokens(timeout=5)
    assert len(toks) == 4 and fin.finish_reason.value == "length"


def test_unknown_quant_mode_is_refused():
    with pytest.raises(ValueError, match="unknown quant mode"):
        InferenceEngine(get_config("test-tiny"), EngineConfig(**ENGINE_FIELDS, quant="int4"),
                        device="cpu")
