"""The port's sharding by spec (``omnia_tpu_torch/parallel``) against the
JAX package's: the spec trees of ``llama.param_specs``,
``kv_cache_specs``, ``paged_kv_specs`` and ``quant.quantize_param_specs``
entry for entry (dense, MoE, tied, untied); ``shard_pytree`` slices whose
ranks join back into the whole tree; ``param_specs_pp`` and a tree
drawn on a pp mesh; ``make_mesh``'s errors; and, over eight spawned gloo
ranks, ``make_mesh(dp=2, sp=2, tp=2)``'s and ``make_mesh(dp=2, pp=2,
tp=2)``'s layouts and their axes' groups; each rank's params and KV
bytes of the NCCL cases' models, reckoned from the spec trees on the
meta device, against the constants ``test_torch_nccl_cuda.py`` asserts
on the cards."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import test_torch_nccl_cuda as nccl_cases
import torch_dpsp_workers as workers

from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import kv_quant as jkvq
from omnia_tpu.models import llama as jllama
from omnia_tpu.models import paged_kv as jpkv
from omnia_tpu.models import quant as jquant
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
from omnia_tpu_torch.models import get_config, llama, quant
from omnia_tpu_torch.parallel.launch import spawn_ranks
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


@pytest.mark.parametrize("model", list(MODELS))
def test_param_specs_pp_equal_jax(model):
    assert _flat(llama.param_specs_pp(get_config(**MODELS[model]))) == \
        _flat(jllama.param_specs_pp(jget_config(**MODELS[model])))


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


def test_init_params_on_a_pp_mesh_draws_the_stages_slices():
    """On a pp x tp mesh each rank draws the whole tree's values and keeps
    its stage's layers of its tp slice; embed and the final norm are
    replicated over pp."""
    cfg = get_config("test-tiny", num_layers=4)
    whole = llama.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    specs = llama.param_specs_pp(cfg)
    for p in range(2):
        for t in range(2):
            mesh = Mesh(shape={"dp": 1, "pp": 2, "tp": 2}, coords={"dp": 0, "pp": p, "tp": t},
                        comms={})
            part = llama.init_params(cfg, torch.Generator().manual_seed(2), "cpu", mesh=mesh)
            want = shard_pytree(whole, specs, mesh)
            assert all(torch.equal(a, b) for a, b in zip(_leaves(part), _leaves(want)))
            assert part["layers"]["ln1"].shape == (2, cfg.hidden_size)
            assert torch.equal(part["final_norm"], whole["final_norm"])


@pytest.mark.parametrize("dims", [dict(tp=16), dict(dp=2, tp=8), dict(dp=4, tp=2, sp=2),
                                  dict(tp=4, pp=4)])
def test_make_mesh_size_error_equals_jax(dims, devices8):
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(**dims, devices=devices8)
    with pytest.raises(ValueError) as terr:
        make_mesh(**dims, world=8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("axis", ["dp", "sp", "pp"])
def test_make_mesh_refuses_unported_axes(axis, devices8):
    """dp, sp and pp are all ported: a mesh of them is refused only over a
    job of the wrong size (one rank per mesh position). pp's case then
    builds make_mesh(dp=2, pp=2, tp=2) over a job of 8 ranks: each rank's
    coordinates and the job ranks of its axis lines are those of device
    ``rank`` in the JAX package's make_mesh(dp=2, pp=2, tp=2) over the 8
    virtual devices."""
    with pytest.raises(ValueError, match=f"a {axis}=2 mesh needs a job of 2 ranks, have 8"):
        make_mesh(**{axis: 2}, world=8)
    if axis != "pp":
        return
    dims = dict(dp=2, pp=2, tp=2)
    jmesh = jmake_mesh(**dims, devices=devices8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = spawn_ranks(workers.mesh_job, 8, args=(dims,), backend="gloo", timeout_s=300)
    for rank, out in enumerate(got):
        where = dict(zip(jmesh.axis_names, (int(i) for i in np.argwhere(ids == rank)[0])))
        assert out["shape"] == dict(jmesh.shape) == dims
        assert out["coords"] == where
        for axis_i, name in enumerate(jmesh.axis_names):
            line = np.moveaxis(ids, axis_i, 0)[(slice(None),) + tuple(
                where[a] for a in jmesh.axis_names if a != name)]
            assert out["lines"][name] == (line.tolist(), where[name])


def test_make_mesh_dp_sp_tp_builds_under_an_eight_rank_group():
    """make_mesh(dp=2, sp=2, tp=2) over a job of 8 ranks: rank (d * 2 + s)
    * 2 + t sits at (d, s, t), and each axis's group is its line, the
    ranks that differ only there, in the axis's order."""
    got = spawn_ranks(workers.mesh_job, 8, args=(dict(dp=2, sp=2, tp=2),), backend="gloo",
                      timeout_s=300)
    for rank, out in enumerate(got):
        d, s, t = rank // 4, rank // 2 % 2, rank % 2
        assert out["shape"] == {"dp": 2, "sp": 2, "tp": 2}
        assert out["coords"] == {"dp": d, "sp": s, "tp": t}
        assert out["lines"] == {"dp": ([s * 2 + t, 4 + s * 2 + t], d),
                                "sp": ([d * 4 + t, d * 4 + 2 + t], s),
                                "tp": ([d * 4 + s * 2, d * 4 + s * 2 + 1], t)}


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


# (model, mesh shape, slots a dp shard or None, the card test's params and
# KV constants): the NCCL cases that hold each rank's bytes.
RECKONINGS = {
    "llama3-70b_tp4": ("llama3-70b", dict(dp=1, tp=4), 32, "LLAMA70B_PARAMS_BYTES",
                       "LLAMA70B_KV_BYTES"),
    "mixtral-8x7b_dp2_tp2": ("mixtral-8x7b", dict(dp=2, tp=2), 32, "MIXTRAL_DP_PARAMS_BYTES",
                             "MIXTRAL_DP_KV_BYTES"),
    "mixtral-8x7b_tp4": ("mixtral-8x7b", dict(dp=1, tp=4), None, "MIXTRAL_PARAMS_BYTES", None),
    "llama3-8b_pp2_tp2": ("llama3-8b", dict(dp=1, pp=2, tp=2), None, "TRAIN_8B_PARAMS_BYTES",
                          None),
}


@pytest.mark.parametrize("case", list(RECKONINGS))
def test_rank_bytes_equal_the_nccl_cases_constants(case):
    """Every rank's bf16 params (``init_params(mesh=)`` on the meta device:
    shapes only, nothing allocated) and, for a serving case, its KV cache
    of 1,024 rows a slot, in bytes, equal the constants the four-card
    cases assert, so a wrong constant fails here and not after a card
    call. The trainer's gradients and both AdamW moments take the params'
    dtype, so its state is four times the params constant."""
    name, shape, slots, params_const, kv_const = RECKONINGS[case]
    cfg = get_config(name)
    axes = list(shape)
    for coords in np.ndindex(*shape.values()):
        mesh = Mesh(shape=shape, coords=dict(zip(axes, coords)), comms={})
        params = llama.init_params(cfg, None, "meta", dtype=torch.bfloat16, mesh=mesh)
        assert all(t.is_meta for t in _leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        assert nbytes == getattr(nccl_cases, params_const), (coords, nbytes)
        if kv_const is not None:
            k, v = llama.init_kv_cache(cfg, slots, 1024, "meta", tp=shape["tp"])
            kv = sum(t.numel() * t.element_size() for t in (k, v))
            assert kv == getattr(nccl_cases, kv_const), kv
