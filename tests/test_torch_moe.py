"""The port's Mixtral MoE (``omnia_tpu_torch/ops/moe.py`` and the MoE
branch of ``models/llama.py``) held against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
routing (top experts equal, a tie going to the lower index as
``jax.lax.top_k`` does), the all-expert MLP, capacity dispatch at E = 8
with a skewed router so that assignments drop (and the test shows that
they do), the shape rule of ``moe_mlp`` at 63 and 64 rows, and the
forward of ``test-tiny-moe`` (prefills below and above 64 rows, decode
steps over each of the four KV caches). Tolerances: 1e-6 on router
weights and 1e-5 on outputs and logits at f32. At bf16, 2^-6 of the
output's largest magnitude: the gate, up, activation, down products and
the combine each round to bf16, and the two packages' summation orders
leave the outputs up to two bf16 steps apart at the top of their range
(2.0 at most over 72 seeded cases of 1–200 rows)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.ops import moe as jmoe
from omnia_tpu_torch import ops as tops
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.ops import moe as tmoe

D, FF, E, K = 64, 128, 8, 2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_ATOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _inputs(n: int, dtype: str, seed: int = 0, skew: float = 1.0, tie: bool = False):
    """h [1, n, D] (a positive mean in every feature) and an expert layer
    (router [D, E], wg / wu [E, D, F], wd [E, F, D]) as numpy f32 rounded
    to ``dtype``. ``skew`` > 1 makes router column 0 positive and scales
    it, so that most rows rank expert 0 first and it overflows its
    capacity; ``tie`` makes columns 1 and 3 equal."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((1, n, D)) + 0.3).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
    if skew != 1.0:
        router[:, 0] = np.abs(router[:, 0]) * skew
    if tie:
        router[:, 3] = router[:, 1]
    p = {"router": router,
         "wg": (rng.standard_normal((E, D, FF)) * 0.1).astype(np.float32),
         "wu": (rng.standard_normal((E, D, FF)) * 0.1).astype(np.float32),
         "wd": (rng.standard_normal((E, FF, D)) * 0.1).astype(np.float32)}
    jh = jnp.asarray(h, JDT[dtype])
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in p.items()}
    th = torch.from_numpy(h).to(TDT[dtype])
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in p.items()}
    return jh, jp, th, tp


def _assert_out(got: torch.Tensor, want, dtype: str):
    want = _np(want)
    atol = F32_ATOL if dtype == "float32" else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0)


def _drops(top_i: np.ndarray, n: int, capacity_factor: float) -> int:
    """Assignments past their expert's capacity in a dispatch of n rows."""
    capacity = max(1, int(-(-n * K * capacity_factor // E)))
    counts = np.bincount(top_i.reshape(-1), minlength=E)
    return int(np.maximum(counts - capacity, 0).sum())


def test_ops_exports_match_jax():
    assert tops.DISPATCH_MIN_TOKENS == jmoe.DISPATCH_MIN_TOKENS == 64
    for name in ("route_sparse", "route_topk", "moe_dense", "moe_dispatch", "moe_mlp"):
        assert getattr(tops, name) is getattr(tmoe, name)


@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("tie", [False, True])
def test_route_sparse_and_topk_match_jax(dtype, tie):
    """Top experts equal and renormalized weights within 1e-6 (f32) or one
    bf16 step; with two equal router columns the lower index wins, on
    rows where the tie sits on the top-K boundary."""
    jh, jp, th, tp = _inputs(256, dtype, seed=1, tie=tie)
    jw, ji = jmoe.route_sparse(jh, jp["router"], K)
    tw, ti = tmoe.route_sparse(th, tp["router"], K)
    assert tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               atol=1e-6 if dtype == "float32" else 2.0 ** -8)
    jc = jmoe.route_topk(jh, jp["router"], K)
    tc = tmoe.route_topk(th, tp["router"], K)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                               atol=1e-6 if dtype == "float32" else 2.0 ** -8)
    if tie:
        # Rows whose K-th and (K+1)-th experts are the tied pair: both
        # packages keep expert 1, never expert 3.
        logits = np.asarray(jnp.dot(jh, jp["router"]).astype(jnp.float32))[0]
        order = np.argsort(-logits, axis=-1, kind="stable")
        boundary = (np.sort(order[:, K - 1:K + 1], axis=-1) == [1, 3]).all(axis=-1)
        assert boundary.sum() >= 10
        kept = ti.numpy()[0][boundary]
        assert (kept == 1).any(axis=-1).all() and not (kept == 3).any()


@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("n", [1, 8, 63])
def test_moe_dense_matches_jax(dtype, n):
    jh, jp, th, tp = _inputs(n, dtype, seed=2)
    got = tmoe.moe_dense(th, tp, K)
    assert got.dtype == TDT[dtype] and got.shape == th.shape
    _assert_out(got, jmoe.moe_dense(jh, jp, K), dtype)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("dtype", sorted(JDT))
def test_moe_dispatch_drops_like_jax(dtype, capacity_factor):
    """E = 8, K = 2, a router whose column 0 is scaled up: expert 0
    overflows its capacity, and the port drops what JAX drops."""
    n = 96
    jh, jp, th, tp = _inputs(n, dtype, seed=3, skew=3.0)
    _, ji = jmoe.route_sparse(jh, jp["router"], K)
    _, ti = tmoe.route_sparse(th, tp["router"], K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _drops(np.asarray(ji), n, capacity_factor) > 0
    got = tmoe.moe_dispatch(th, tp, K, capacity_factor)
    _assert_out(got, jmoe.moe_dispatch(jh, jp, K, capacity_factor), dtype)
    # A dropped assignment contributes nothing: rows whose both experts
    # dropped are zero in both packages.
    zero = ~_np(got).any(axis=-1)
    np.testing.assert_array_equal(zero, ~_np(jmoe.moe_dispatch(jh, jp, K, capacity_factor))
                                  .any(axis=-1))
    if capacity_factor < 1.0:
        assert zero.any()


class _OneShard:
    """A dp Comm of one shard that records what the dispatch all-gathers."""
    size, index = 1, 0

    def __init__(self):
        self.gathered = []

    def all_gather(self, x, dim=-1):
        self.gathered.append(x.clone())
        return x


@pytest.mark.parametrize("dtype", sorted(JDT))
def test_padding_rows_take_no_expert_slot(dtype):
    """A shard padded to GSPMD's block (``ShardRows``: two real rows of 48
    tokens and a padding row that ranks expert 0 first, as the real ones
    mostly do): the real rows' outputs are JAX's dispatch over the real
    rows alone, drops included, and the per-expert counts the shard
    all-gathers are the real rows' own."""
    from omnia_tpu_torch.parallel.collectives import ShardRows

    jh, jp, th, tp = _inputs(96, dtype, seed=3, skew=3.0)
    th, jh = th.reshape(2, 48, D), jh.reshape(2, 48, D)
    top_i = tmoe.route_sparse(th, tp["router"], K)[1].numpy()
    assert _drops(top_i, 96, 2.0) > 0
    comm = _OneShard()
    got = tmoe.moe_dispatch(torch.cat([th, th[:1]]), tp, K, dp=ShardRows(comm, 2, 2))
    _assert_out(got[:2], jmoe.moe_dispatch(jh, jp, K), dtype)
    np.testing.assert_array_equal(comm.gathered[0].numpy()[0],
                                  np.bincount(top_i.reshape(-1), minlength=E))


@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("n", [63, 64])
def test_moe_mlp_branches_at_64_rows_like_jax(dtype, n):
    """63 rows take the all-expert path, 64 capacity dispatch; with a
    skewed router the two differ at 64 rows (drops), and the port's
    branch gives JAX's numbers on both sides."""
    jh, jp, th, tp = _inputs(n, dtype, seed=4, skew=3.0)
    got = tmoe.moe_mlp(th, tp, K)
    _assert_out(got, jmoe.moe_mlp(jh, jp, K), dtype)
    same = tmoe.moe_dense(th, tp, K) if n < 64 else tmoe.moe_dispatch(th, tp, K)
    assert torch.equal(got, same)
    if n == 64:
        assert _drops(tmoe.route_sparse(th, tp["router"], K)[1].numpy(), n, 2.0) > 0
        assert not torch.equal(got, tmoe.moe_dense(th, tp, K))


def test_expert_weights_are_read_in_place(monkeypatch):
    """The products take each layer's [E, D, F] weight as it lies in the
    stacked tree: no copy, no permute of a weight."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(b)
        return real(a, b)

    monkeypatch.setattr(tmoe.torch, "matmul", spy)
    cfg = get_config("test-tiny-moe")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                dtype=torch.float32)
    lp = tllama._layers(params)[1]["mlp"]
    for name in ("router", "wg", "wu", "wd"):
        assert lp[name].data_ptr() == params["layers"]["mlp"][name][1].data_ptr()
    for t in (1, 70):
        seen.clear()
        tmoe.moe_mlp(torch.randn(1, t, cfg.hidden_size), lp, cfg.num_experts_per_tok)
        ptrs = {b.data_ptr() for b in seen}
        assert {lp[n].data_ptr() for n in ("router", "wg", "wu", "wd")} <= ptrs


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _close(out: torch.Tensor, ref, atol=F32_ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_init_params_shapes_and_stds_match_jax():
    cfg, jcfg = get_config("test-tiny-moe"), jget_config("test-tiny-moe")
    tp = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            dtype=torch.float32)
    jp = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0),
                                                     dtype=jnp.float32))
    L = cfg.num_layers
    assert tp["layers"]["mlp"]["router"].shape == (L, cfg.hidden_size, cfg.num_experts)
    for name, leaf in tp["layers"]["mlp"].items():
        ref = jp["layers"]["mlp"][name]
        assert tuple(leaf.shape) == ref.shape, name
        np.testing.assert_allclose(leaf.std().item(), ref.std(), rtol=0.15, err_msg=name)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == cfg.num_params()


def _cache_pair(jcfg, tcfg, B, S, kv_quant, paged, PS=16):
    from omnia_tpu.models.paged_kv import PagedKV as JPagedKV
    from omnia_tpu_torch.models.paged_kv import PagedKV

    if not paged:
        return (jllama.init_kv_cache(jcfg, B, S, dtype=jnp.float32, kv_quant=kv_quant),
                tllama.init_kv_cache(tcfg, B, S, "cpu", dtype=torch.float32,
                                     kv_quant=kv_quant))
    table = (np.random.default_rng(2).permutation(B * S // PS) + 1).reshape(B, -1)
    table = table.astype(np.int32)
    jck, jcv = jllama.init_kv_cache(jcfg, 1 + B * S // PS, PS, dtype=jnp.float32,
                                    kv_quant=kv_quant)
    tck, tcv = tllama.init_kv_cache(tcfg, 1 + B * S // PS, PS, "cpu", dtype=torch.float32,
                                    kv_quant=kv_quant)
    tt = torch.from_numpy(table)
    return ((JPagedKV(jck, jnp.asarray(table)), JPagedKV(jcv, jnp.asarray(table))),
            (PagedKV(tck, tt), PagedKV(tcv, tt)))


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg, tcfg = jget_config("test-tiny-moe"), get_config("test-tiny-moe")
    jparams = jllama.init_params(jcfg, jax.random.key(5), dtype=jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("T", [5, 80])
def test_forward_prefill_matches_jax(tiny_moe, T):
    """T = 5 runs the all-expert MLP (10 rows), T = 80 capacity dispatch."""
    jcfg, tcfg, jparams, tparams = tiny_moe
    B = 2
    tokens = np.random.default_rng(T).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jl, jk, jv = jllama.forward_prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    tl, tk, tv = tllama.forward_prefill(tparams, tcfg, torch.from_numpy(tokens),
                                        torch.from_numpy(pos))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("T", [5, 80])
@pytest.mark.parametrize("kv_quant,paged", [(None, False), ("int8", False), (None, True),
                                            ("int8", True)])
def test_forward_over_each_cache_matches_jax(tiny_moe, kv_quant, paged, T):
    """A prefill of T rows per slot through ``forward``, then three decode
    steps at per-slot positions fed JAX's greedy tokens: logits within
    1e-5 at every step over float caches. Over int8 caches within 1e-4,
    the dense model's tolerance there (tests/test_torch_llama.py): a row
    value within f32 rounding of a .5 step may quantize to the
    neighbouring int8 value in the other package."""
    jcfg, tcfg, jparams, tparams = tiny_moe
    B, S = 2, 96
    (jck, jcv), (tck, tcv) = _cache_pair(jcfg, tcfg, B, S, kv_quant, paged)
    rng = np.random.default_rng(T + 1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()

    def step(tok, p, start):
        nonlocal jck, jcv
        jl, jck, jcv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(p),
                                      jck, jcv, jnp.asarray(start))
        tl, _, _ = tllama.forward(tparams, tcfg, torch.from_numpy(tok), torch.from_numpy(p),
                                  tck, tcv, torch.from_numpy(start))
        _close(tl, jl, atol=1e-4 if kv_quant else F32_ATOL)
        return np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)

    cur = step(tokens, pos, np.zeros(B, np.int32))
    positions = np.array([T, T + 3], np.int32)
    for _ in range(3):
        cur = step(cur[:, None], positions[:, None], positions)
        positions = positions + 1
