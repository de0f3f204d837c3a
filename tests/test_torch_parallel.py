"""The port's sharding by spec (``omnia_tpu_torch/parallel``) against the
JAX package's, in one process: the spec trees of ``llama.param_specs``,
``kv_cache_specs``, ``paged_kv_specs`` and ``quant.quantize_param_specs``
entry for entry (dense, MoE, tied, untied); ``shard_pytree`` slices whose
ranks join back into the whole tree; and ``make_mesh``'s errors."""

from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import kv_quant as jkvq
from omnia_tpu.models import llama as jllama
from omnia_tpu.models import paged_kv as jpkv
from omnia_tpu.models import quant as jquant
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
from omnia_tpu_torch.models import get_config, llama, quant
from omnia_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from omnia_tpu_torch.parallel.sharding import P, gather_pytree, shard_pytree

MODELS = {
    "dense": dict(name="test-tiny"),
    "moe": dict(name="test-tiny-moe"),
    "tied": dict(name="test-tiny", tie_embeddings=True),
    "gqa8": dict(name="test-tiny-gqa8"),
}


def _flat(tree, path=""):
    """(path, spec entries) of a spec tree of either package."""
    if isinstance(tree, (JP, P)):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}/{k}")]
    for cls, fields in ((jkvq.QuantKV, ("q", "s")), (jpkv.PagedKV, ("pool", "table"))):
        if isinstance(tree, cls):
            return [x for f in fields for x in _flat(getattr(tree, f), f"{path}/{f}")]
    fields = getattr(type(tree), "__slots__", None)
    if fields:
        return [x for f in fields for x in _flat(getattr(tree, f), f"{path}/{f}")]
    return [x for i, t in enumerate(tree) for x in _flat(t, f"{path}/{i}")]


@pytest.mark.parametrize("model", list(MODELS))
def test_param_specs_equal_jax(model):
    assert _flat(llama.param_specs(get_config(**MODELS[model]))) == \
        _flat(jllama.param_specs(jget_config(**MODELS[model])))


@pytest.mark.parametrize("mode", ["int8", "int8-dynamic"])
@pytest.mark.parametrize("model", ["dense", "moe", "tied"])
def test_quantize_param_specs_equal_jax(model, mode):
    cfg, jcfg = get_config(**MODELS[model]), jget_config(**MODELS[model])
    got = quant.quantize_param_specs(llama.param_specs(cfg), cfg, mode)
    want = jquant.quantize_param_specs(jllama.param_specs(jcfg), jcfg, mode)
    assert _flat(got) == _flat(want)


def test_quantize_param_specs_refuses_short_specs():
    cfg = get_config("test-tiny")
    specs = llama.param_specs(cfg)
    specs["layers"]["attn"]["wq"] = P(None, "tp")
    with pytest.raises(ValueError, match="2 entries, expected 3"):
        quant.quantize_param_specs(specs, cfg)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_specs_equal_jax(kv_quant):
    assert _flat(llama.kv_cache_specs(kv_quant)) == _flat(jllama.kv_cache_specs(kv_quant))
    assert _flat(llama.paged_kv_specs(kv_quant)) == _flat(jllama.paged_kv_specs(kv_quant))


def _mesh(tp: int, rank: int) -> Mesh:
    """A rank's view of a tp mesh without a process group (slicing only)."""
    return Mesh(shape={"dp": 1, "tp": tp}, coords={"dp": 0, "tp": rank}, comms={})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("model,mode", [
    (model, mode) for model in ("dense", "moe", "tied", "gqa8")
    for mode in (None, "int8", "int8-dynamic")
    if not (model == "moe" and mode)])          # int8 weights do not cover MoE experts
def test_shards_join_into_the_whole_tree(model, mode):
    """Each rank's slice of every leaf, joined along its split axis in rank
    order, is the leaf; a W8A8 weight keeps its column-major layout."""
    cfg = get_config(**MODELS[model])
    whole = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    specs = llama.param_specs(cfg)
    if mode:
        whole = quant.quantize_params(whole, cfg, mode)
        specs = quant.quantize_param_specs(specs, cfg, mode)
    tp = 2
    shards = [shard_pytree(whole, specs, _mesh(tp, r)) for r in range(tp)]
    flat_specs = [s for _, s in _flat(specs)]
    for i, (full, spec) in enumerate(zip(_leaves(whole), flat_specs)):
        parts = [_leaves(sh)[i] for sh in shards]
        axis = [d for d, a in enumerate(spec) if a == "tp"]
        joined = torch.cat(parts, dim=axis[0]) if axis else parts[0]
        assert torch.equal(joined, full)
        if full.dim() > 1 and full.stride(-2) == 1 and full.shape[-2] > 1:
            assert all(part.stride(-2) == 1 for part in parts)   # column-major kept
    # tp = 1: the whole tree, and gathering it is the identity.
    one = single_device_mesh()
    same = gather_pytree(shard_pytree(whole, specs, one), specs, one)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(same), _leaves(whole)))


def test_init_params_with_a_mesh_draws_the_whole_trees_slices():
    cfg = get_config("test-tiny")
    whole = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for r in range(2):
        part = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu", mesh=_mesh(2, r))
        want = shard_pytree(whole, llama.param_specs(cfg), _mesh(2, r))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(part), _leaves(want)))
        assert llama.params_sharded(part, cfg, 2) and not llama.params_sharded(whole, cfg, 2)


@pytest.mark.parametrize("dims", [dict(tp=16), dict(dp=2, tp=8), dict(dp=4, tp=2, sp=2),
                                  dict(tp=4, pp=4)])
def test_make_mesh_size_error_equals_jax(dims, devices8):
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(**dims, devices=devices8)
    with pytest.raises(ValueError) as terr:
        make_mesh(**dims, world=8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("axis", ["dp", "sp", "pp"])
def test_make_mesh_refuses_unported_axes(axis):
    with pytest.raises(ValueError, match=f"{axis}=2 is not ported.*ROADMAP A13"):
        make_mesh(**{axis: 2}, world=8)


def test_make_mesh_tp_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(tp=2, world=2)
    mesh = make_mesh(tp=1, world=1)
    assert mesh.axis_names == ("dp", "tp") and mesh.comm("tp") is None
    assert mesh.axis_names == tuple(jmake_mesh(1, 1, devices=jax.devices()[:1]).axis_names)


@pytest.mark.parametrize("fields,match", [
    (dict(tp=3), "tp=3 must divide num_kv_heads=2"),
    (dict(tp=0), "tp must be >= 1"),
])
def test_engine_refuses_a_tp_it_cannot_split(fields, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(get_config("test-tiny"), EngineConfig(**fields), device="cpu")
