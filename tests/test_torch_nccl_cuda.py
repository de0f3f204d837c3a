"""The NCCL route of the port's tensor, data, sequence and pipeline
parallelism, one rank per card: the NCCL branches of
``parallel/collectives.py::Comm`` (the sp ring's and the pipeline's
point-to-point steps among them), of ``engine/multihost.py::LockstepEngine``
and of the sharded trainer's backward, which the gloo tests and
``chip_smoke.py`` phases 14-16 (ranks sharing one card) never take. This
file imports neither jax nor omnia_tpu, so run it on a host with two or
more cards without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_nccl_cuda.py -q

With fewer cards than a case's ranks the case skips."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_dpsp_workers as dpsp_workers
import torch_pp_workers as pp_workers
import torch_tp_workers as workers
from omnia_tpu_torch import kernels
from omnia_tpu_torch.parallel.launch import spawn_ranks


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_collectives_and_lockstep_tokens(world):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards: NCCL takes one rank per card")
    kernels.build_all()                   # once, before the ranks load the kernels
    got = spawn_ranks(workers.nccl_job, world, backend="nccl", timeout_s=600,
                      rank_timeout_s=120)
    for r, g in enumerate(got):
        assert g["backend"] == "nccl"
        assert g["device"] == g["K1_engine_device"] == f"cuda:{r}" and g["current"] == r
    check_values(got)


def check_values(got: list) -> None:
    """Each rank's collectives against the host's reckoning of them, and
    the leader's tp tokens against its tp = 1 engine's."""
    xs = [workers.nccl_rows(r) for r in range(len(got))]
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)
        ins = [torch.from_numpy(x).to(dt).double().numpy() for x in xs]
        exact = np.sum(ins, 0)
        # f32 sums in any order; a 16-bit sum is reduced in f32 and rounded
        # once, so within half a bf16 ulp of the exact sum (a bf16
        # reduction rounds world - 1 times).
        rtol = 1e-6 if dt == torch.float32 else 2.0 ** -8
        want_max = torch.from_numpy(np.max(ins, 0)).to(dt).float().numpy()
        for g in got:
            np.testing.assert_allclose(g[f"sum_{key}"], exact, rtol=rtol, atol=1e-6)
            np.testing.assert_array_equal(g[f"sum_{key}"], got[0][f"sum_{key}"])  # same bytes
            np.testing.assert_array_equal(g[f"max_{key}"], want_max)
    for g in got:
        np.testing.assert_array_equal(
            g["gather"], torch.from_numpy(np.concatenate(xs, -1)).bfloat16().float().numpy())
        np.testing.assert_array_equal(g["broadcast"], np.arange(5, dtype=np.uint8))
    for label in workers.NCCL_CACHES:
        assert got[0][label] == got[0][f"{label}_tp1"], label
        assert all(len(t) == 12 for t in got[0][label])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [dict(dp=2, tp=2), dict(sp=2, tp=2)],
                         ids=["dp2_tp2", "sp2_tp2"])
def test_nccl_dp_sp_collectives_and_lockstep_tokens(dims):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(dpsp_workers.nccl_mesh_job, 4, args=(dims,), backend="nccl",
                      timeout_s=600, rank_timeout_s=120)
    for r, g in enumerate(got):
        assert g["backend"] == "nccl" and g["device"] == f"cuda:{r}"
    check_mesh_values(got, dims)


def check_mesh_values(got: list, dims: dict) -> None:
    """The ring shift brings each rank the rows of the previous rank of
    its sp ring (rank - tp, cyclically, at sp = 2 x tp = 2); the dp gather
    joins the tokens of the ranks of its dp group (rank mod tp, + tp) in
    shard order; the leader's tokens equal its tp = 1 engine's, and under
    sp the 20-token prompt took the ring on every rank."""
    tp = dims["tp"]
    xs = [workers.nccl_rows(r) for r in range(len(got))]
    for r, g in enumerate(got):
        if "sp" in dims:
            prev = (r - tp) % len(got)
            np.testing.assert_array_equal(g["shift"], xs[prev])
            np.testing.assert_array_equal(
                g["shift_bf16"], torch.from_numpy(xs[prev]).bfloat16().float().numpy())
        else:
            t = r % tp
            toks = [np.arange(8, dtype=np.int32).reshape(4, 2) + 100 * q for q in (t, t + tp)]
            np.testing.assert_array_equal(g["gather"], np.concatenate(toks, 1))
    for label in workers.NCCL_CACHES:
        assert got[0][label] == got[0][f"{label}_tp1"], label
        assert all(len(t) == 12 for t in got[0][label])
        if "sp" in dims:
            assert all(g[f"{label}_rings"] == 1 for g in got)


@pytest.mark.cuda
def test_nccl_pp_tp_train_step():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    got = spawn_ranks(pp_workers.nccl_train_job, 4, backend="nccl", timeout_s=600,
                      rank_timeout_s=120)
    for r, g in enumerate(got):
        assert g["backend"] == "nccl" and g["device"] == f"cuda:{r}"
    check_train_values(got)


def check_train_values(got: list) -> None:
    """One train_step at pp = 2 x tp = 2: the loss on every rank and each
    gradient leaf, gathered whole, equal the one-rank step's (f32, TF32
    off: summation order only)."""
    want = got[0]["loss_tp1"]
    for g in got:
        assert abs(g["loss"] - want) <= 1e-5 * abs(want)
    ref = got[0]["grads_tp1"]

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in flat(v, f"{path}/{k}")]
        return [(path, tree)]

    for (path, a), (_, b) in zip(flat(got[0]["grads"]), flat(ref)):
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), path
