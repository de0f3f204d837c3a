"""The NCCL route of the port's tensor parallelism, one rank per card:
the NCCL branches of ``parallel/collectives.py::Comm`` and of
``engine/multihost.py::LockstepEngine``, which the gloo tests and
``chip_smoke.py`` phase 14 (ranks sharing one card) never take. This
file imports neither jax nor omnia_tpu, so run it on a host with two or
more cards without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_nccl_cuda.py -q

With fewer cards than a case's ranks the case skips."""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
