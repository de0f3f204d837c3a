"""The NCCL route of the port's tensor, data, sequence and pipeline
parallelism, one rank per card: the NCCL branches of
``parallel/collectives.py::Comm`` (the sp ring attention's and the
pipeline's point-to-point steps among them), of
``engine/multihost.py::LockstepEngine``, of the sharded trainer's
backward, and the decode ring's captured graphs whose steps hold NCCL
collectives (``engine/graphs.py``), which the gloo tests and
``chip_smoke.py`` phases 14-17 (ranks sharing one card) never take; and
the whole models that need more than one card: llama3-8b at tp = 2,
Mixtral-8x7B at tp = 4 and at dp = 2 x tp = 2 with 64 decode rows,
Llama-3-70B in bf16 at tp = 4 (each held at 2 layers against one card,
then served ring on and off), llama3-8b trained in bf16 at pp = 2 x tp
= 2. This file imports neither jax nor omnia_tpu, so run it on a host
with two or more cards without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_nccl_cuda.py -q

With fewer cards than a case's ranks the case skips. Every spawn passes
``torch_ring_workers.rank_env``: the ranks' warmup manifests go to a
temporary directory, not into the kernel build cache."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_dpsp_workers as dpsp_workers
import torch_pp_workers as pp_workers
import torch_ring_workers as ring_workers
import torch_tp_workers as workers
from omnia_tpu_torch import kernels
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.parallel.launch import spawn_ranks
from omnia_tpu_torch.train import trainer


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    return tmp_path_factory.mktemp("manifests")


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_collectives_and_lockstep_tokens(world, manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards: NCCL takes one rank per card")
    kernels.build_all()                   # once, before the ranks load the kernels
    got = spawn_ranks(workers.nccl_job, world, backend="nccl",
                      env=ring_workers.rank_env(manifests), timeout_s=600, rank_timeout_s=120)
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
def test_nccl_dp_sp_collectives_and_lockstep_tokens(dims, manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(dpsp_workers.nccl_mesh_job, 4, args=(dims,), backend="nccl",
                      env=ring_workers.rank_env(manifests), timeout_s=600, rank_timeout_s=120)
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
def test_nccl_pp_tp_train_step(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    got = spawn_ranks(pp_workers.nccl_train_job, 4, backend="nccl",
                      env=ring_workers.rank_env(manifests), timeout_s=600, rank_timeout_s=120)
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


RING_MESHES = {"tp2": dict(tp=2), "tp4": dict(tp=4), "dp2_tp2": dict(dp=2, tp=2),
               "sp2_tp2": dict(sp=2, tp=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RING_MESHES))
def test_nccl_decode_ring_graphs(name, manifests):
    dims = RING_MESHES[name]
    world = int(np.prod(list(dims.values())))
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(ring_workers.nccl_ring_job, world, args=(dims,), backend="nccl",
                      env=ring_workers.rank_env(manifests, ring=True), timeout_s=300,
                      rank_timeout_s=120)
    for r, g in enumerate(got):
        assert g["backend"] == "nccl" and g["device"] == f"cuda:{r}"
    check_ring_values(got, dims)


def check_ring_values(got: list, dims: dict) -> None:
    """On K1 and K4: every rank's ring engine captured its graphs, and its
    steps hold collectives over tp (and over dp: the early-out's OR);
    its greedy rows equal the ring-off engine's and the one-rank engine's;
    each rank's kernel launched num_layers x the steps that ran, counted on
    the card, and no other kernel. Under dp the dp script's sampler states,
    sampled streams and books equal the dp = 1 ring engine's."""
    for label in ring_workers.NCCL_RING_CACHES:
        for g in got:
            on, off = g[(label, "on")], g[(label, "off")]
            assert on["captured"] and not off["captured"]
            axes = set(on["step_collectives"])
            assert ("tp" in axes) == (dims.get("tp", 1) > 1), on["step_collectives"]
            assert ("dp" in axes) == (dims.get("dp", 1) > 1), on["step_collectives"]
            assert on["rows"] == off["rows"] == got[0][(label, "tp1")], label
            for res in (on, off):
                assert res["ran"] > 0
                assert res["launches"][res["edition"]] == res["layers"] * res["ran"], res
                assert sum(res["launches"].values()) == res["launches"][res["edition"]]
    if dims.get("dp", 1) > 1:
        for g in got:
            dp, one = g["dp"], g["dp1"]
            assert dp["slots"] and one["slots"]
            np.testing.assert_array_equal(dp["keys"], one["keys"])
            for key in ("batch", "late", "books"):
                assert dp[key] == one[key], key


@pytest.mark.cuda
def test_nccl_llama3_8b_tp2_ring_on_and_off(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(ring_workers.nccl_8b_job, 2, backend="nccl",
                      env=ring_workers.rank_env(manifests, ring=True), timeout_s=600,
                      rank_timeout_s=300)
    check_8b_values(got)


def _card() -> list:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()


def check_windows(g: dict) -> None:
    """One rank's burst windows: its captured step holds tp collectives,
    and in every window of both arms the decode-attention launches,
    counted on the card, are num_layers x the steps that ran, all of the
    engine's edition."""
    assert g["step_collectives"]["tp"]["calls"] > 0
    for arm in ("on", "off"):
        for w in g["windows"][arm]:
            assert w["decode_steps"] > 0 and w["ran"] > 0
            assert w["launches"][g["edition"]] == g["layers"] * w["ran"], (arm, w)
            assert sum(w["launches"].values()) == w["launches"][g["edition"]], (arm, w)


def _serving_line(got: list) -> dict:
    """The numbers every whole-model serving case prints: per arm the
    leader's host ms per decode step, and every rank's chunks' device ms
    per step (CUDA events) against its weight-read bound and their share
    of the window's wall; each rank's bytes, slots, seconds and peaks."""
    bound = [g["params_bytes"] / HBM_BYTES_PER_S * 1e3 for g in got]
    arms = list(got[0]["windows"])
    return dict(
        card=_card(), greedy_tokens=sum(map(len, got[0]["greedy"]["on"])),
        host_ms_per_decode_step={arm: [w["host_ms_per_decode_step"]
                                       for w in got[0]["windows"][arm]] for arm in arms},
        chunk_device_ms_per_step={arm: [[w["chunk_device_ms_per_step"] for w in g["windows"][arm]]
                                        for g in got] for arm in arms},
        weight_read_bound_ms=bound,
        chunk_device_share={arm: [[w["chunk_device_share"] for w in g["windows"][arm]]
                                  for g in got] for arm in arms},
        launches_vs_layers_x_ran=[{arm: [(w["launches"][g["edition"]], g["layers"] * w["ran"])
                                         for w in g["windows"][arm]] for arm in arms}
                                  for g in got],
        windows=[g["windows"] for g in got],
        params_bytes_per_rank=[g["params_bytes"] for g in got],
        kv_bytes_per_rank=[g["kv_bytes"] for g in got], slots_per_rank=[g["slots"] for g in got],
        capture_s=[g["capture_s"] for g in got], pool_bytes=[g["pool_bytes"] for g in got],
        step_collectives=[g["step_collectives"] for g in got],
        warmup_s=[{arm: g[f"warmup_s_{arm}"] for arm in ("on", "off")} for g in got],
        init_s=[g["init_s"] for g in got], init_peak_bytes=[g["init_peak_bytes"] for g in got],
        serving_peak_bytes=[g["serving_peak_bytes"] for g in got])


def check_8b_values(got: list) -> None:
    """The ring's greedy tokens equal ring-off's over the whole burst;
    each rank holds half of every split leaf; the numbers are printed
    (``pytest -s``) beside the card's name and power limit."""
    import json

    greedy = got[0]["greedy"]
    assert greedy["on"] == greedy["off"]
    assert got[0]["params_bytes"] == got[1]["params_bytes"]
    for g in got:
        check_windows(g)
    print("nccl llama3-8b tp=2 " + json.dumps(_serving_line(got)), flush=True)


def check_width(got: list, experts: int, slots: int) -> float:
    """A whole-model case's (1): at full width, 2 layers, f32, the mesh's
    logits of every prefill and step within 1e-3 of one card's, the mesh
    engine's greedy tokens equal one card's, ``experts`` experts and
    ``slots`` slots a rank, the engine's kernel the ring's. Returns the
    largest logits error."""
    check = got[0]["check"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(check["logits"], check["logits_tp1"]))
    assert err <= ring_workers.WIDTH_CHECK_LOGITS_TOL, err
    assert check["greedy"] == check["greedy_tp1"]
    assert all(len(t) == ring_workers.WIDTH_CHECK_NEW_TOKENS for t in check["greedy"])
    for g in got:
        c = g["check"]
        assert (c["experts"], c["slots"], c["edition"]) == (experts, slots, g["edition"]), c
    return err


# Each rank's params and KV bytes (bf16): the per-rank slice of every split
# leaf, the norms and the router whole (``tests/test_torch_parallel.py``
# reckons each from the port's spec trees). Mixtral-8x7B at tp = 4:
# 11,676,684,288 elements a rank.
MIXTRAL_PARAMS_BYTES = 23_353_368_576
# Mixtral-8x7B at dp = 2 x tp = 2 (dp replicates the weights) and its KV
# of 32 slots x 1,024 rows x 32 layers x 4 KV heads a rank.
MIXTRAL_DP_PARAMS_BYTES, MIXTRAL_DP_KV_BYTES = 46_704_107_520, 2_147_483_648
# Llama-3-70B at tp = 4 and its KV of 32 slots x 1,024 rows x 80 layers x
# 2 KV heads a rank (81,920 bytes a slot-row).
LLAMA70B_PARAMS_BYTES, LLAMA70B_KV_BYTES = 35_278_831_616, 2_684_354_560
# llama3-8b at pp = 2 x tp = 2: a stage's 16 layers and half of embed and
# lm_head (replicated over pp); its gradients as many bytes, and the two
# AdamW moments twice as many.
TRAIN_8B_PARAMS_BYTES = 4_540_604_416
# H100 SXM's HBM rate, for the weight-read bound of a decode step.
HBM_BYTES_PER_S = 3.35e12


def off_by(got: int, want: int) -> str:
    """How far a rank's bytes lie from the reckoning."""
    return f"{got:,} bytes, {got - want:+,} off the reckoning of {want:,}"


@pytest.mark.cuda
def test_nccl_mixtral_8x7b_tp4_whole(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(ring_workers.nccl_mixtral_job, 4, backend="nccl",
                      env=ring_workers.rank_env(manifests, ring=True), timeout_s=1200,
                      rank_timeout_s=300)
    check_mixtral_values(got)


def check_mixtral_values(got: list) -> None:
    """(1) At full width, 2 layers, f32 (``check_width``): the [8, 8]
    prefill (64 rows: dispatch) and the 8-row decode step (all experts,
    K1), two experts a rank. (2) The whole model in bf16: greedy tokens
    equal ring on and off over the burst; each rank holds
    MIXTRAL_PARAMS_BYTES; every window's decode-attention launches,
    counted on the card, are 32 x the steps that ran, all of the engine's
    edition. The numbers are printed (``pytest -s``) beside the card's
    name and power limit."""
    import json

    err = check_width(got, experts=2, slots=8)
    greedy = got[0]["greedy"]
    assert greedy["on"] == greedy["off"]
    for g in got:
        assert g["params_bytes"] == MIXTRAL_PARAMS_BYTES, off_by(g["params_bytes"],
                                                                 MIXTRAL_PARAMS_BYTES)
        check_windows(g)
    print("nccl mixtral-8x7b tp=4 " + json.dumps(dict(
        _serving_line(got), check_logits_max_abs_err=err,
        check_greedy_tokens=sum(map(len, got[0]["check"]["greedy"])))), flush=True)


@pytest.mark.cuda
def test_nccl_mixtral_8x7b_dp2_tp2_64_rows(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(ring_workers.nccl_moe_dp_job, 4, backend="nccl",
                      env=ring_workers.rank_env(manifests, ring=True), timeout_s=1200,
                      rank_timeout_s=300)
    check_moe_dp_values(got)


def check_moe_dp_values(got: list) -> None:
    """Mixtral-8x7B at dp = 2 x tp = 2 with 64 slots. (1) ``check_width``
    with 64 slots against one card's 64: the [8, 8] prefill and the
    [64, 1] one and the 64-row step take the capacity dispatch over the
    whole batch, with the drops one card makes; four experts and 32 slots
    a rank. (2) The whole model in bf16 over 64 requests: greedy tokens
    equal ring on and off; the captured step holds dp and tp collectives,
    among the dp ones one counts all-gather per layer (and the
    predicate's OR); each rank holds MIXTRAL_DP_PARAMS_BYTES and
    MIXTRAL_DP_KV_BYTES; every window's K1 launches, counted on the card,
    are 32 x the steps that ran."""
    import json

    err = check_width(got, experts=4, slots=32)
    greedy = got[0]["greedy"]
    assert greedy["on"] == greedy["off"]
    for g in got:
        assert g["edition"] == "decode_attention" and g["slots"] == 32
        assert g["params_bytes"] == MIXTRAL_DP_PARAMS_BYTES, off_by(g["params_bytes"],
                                                                    MIXTRAL_DP_PARAMS_BYTES)
        assert g["kv_bytes"] == MIXTRAL_DP_KV_BYTES, off_by(g["kv_bytes"], MIXTRAL_DP_KV_BYTES)
        sc = g["step_collectives"]
        assert sc["dp"]["ops"] == {"all_reduce": 1, "all_gather": g["layers"]}, sc
        assert sc["tp"]["calls"] > 0
        check_windows(g)
    print("nccl mixtral-8x7b dp=2 tp=2 " + json.dumps(dict(
        _serving_line(got), check_logits_max_abs_err=err,
        check_dispatch_drops=got[0]["check"]["dispatch_drops"],
        check_greedy_tokens=sum(map(len, got[0]["check"]["greedy"])))), flush=True)


@pytest.mark.cuda
def test_nccl_llama3_70b_tp4_whole(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    kernels.build_all()
    got = spawn_ranks(ring_workers.nccl_70b_job, 4, backend="nccl",
                      env=ring_workers.rank_env(manifests, ring=True), timeout_s=1200,
                      rank_timeout_s=300)
    check_70b_values(got)


def check_70b_values(got: list) -> None:
    """Llama-3-70B at tp = 4. (1) ``check_width``: a [32, 8] prefill and its
    32-row step, an engine of 8 slots. (2) The whole model in bf16 over 32
    greedy batch-eval requests: greedy tokens equal ring on and off; each
    rank holds LLAMA70B_PARAMS_BYTES and LLAMA70B_KV_BYTES; every
    window's K1 launches, counted on the card, are 80 x the steps that
    ran."""
    import json

    err = check_width(got, experts=0, slots=8)
    greedy = got[0]["greedy"]
    assert greedy["on"] == greedy["off"]
    for g in got:
        assert g["edition"] == "decode_attention" and g["layers"] == 80
        assert g["params_bytes"] == LLAMA70B_PARAMS_BYTES, off_by(g["params_bytes"],
                                                                  LLAMA70B_PARAMS_BYTES)
        assert g["kv_bytes"] == LLAMA70B_KV_BYTES, off_by(g["kv_bytes"], LLAMA70B_KV_BYTES)
        check_windows(g)
    print("nccl llama3-70b tp=4 " + json.dumps(dict(
        _serving_line(got), check_logits_max_abs_err=err,
        check_greedy_tokens=sum(map(len, got[0]["check"]["greedy"])))), flush=True)


@pytest.mark.cuda
def test_nccl_train_8b_bf16_pp2_tp2(manifests):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one rank per card")
    got = spawn_ranks(pp_workers.nccl_train_8b_job, 4, backend="nccl",
                      env=ring_workers.rank_env(manifests), timeout_s=900, rank_timeout_s=300)
    check_train_8b_values(got)


def check_train_8b_values(got: list) -> None:
    """llama3-8b at pp = 2 x tp = 2. (1) Width, 2 layers, f32: the loss on
    every rank within 1e-5 of one card's and every gradient leaf, gathered
    whole, within 1e-4 of the one-card leaf's largest entry (summation
    order only). (2) The whole model in bf16: the loss finite and falling
    from the first step to the last on every rank; each rank's params and
    gradients TRAIN_8B_PARAMS_BYTES and its moments twice that. The
    numbers are printed (``pytest -s``) beside the card's name and power
    limit."""
    import json

    check = got[0]["check"]
    want = check["loss_tp1"]
    for g in got:
        assert g["backend"] == "nccl"
        assert abs(g["check"]["loss"] - want) <= 1e-5 * abs(want)
    grad_err = {path: err / scale for path, (err, scale) in check["grad_err"].items()}
    specs = llama.param_specs_pp(get_config("llama3-8b"))
    assert sorted(grad_err) == sorted(path for path, _ in trainer.leaves(specs))
    assert max(grad_err.values()) <= 1e-4, grad_err
    for g in got:
        losses = [s["loss"] for s in g["steps"]]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert losses == [s["loss"] for s in got[0]["steps"]]
        for key, n in g["state_bytes"].items():
            reckoned = TRAIN_8B_PARAMS_BYTES * (2 if key == "moments" else 1)
            assert n == reckoned, (key, off_by(n, reckoned))
    tokens = got[0]["tokens_per_step"]
    print("nccl llama3-8b train pp=2 tp=2 " + json.dumps(dict(
        card=_card(), check_loss=[check["loss"], want], check_grad_err_of_largest=grad_err,
        losses=[s["loss"] for s in got[0]["steps"]],
        step_ms=[[s["ms"] for s in g["steps"]] for g in got],
        tokens_per_s=[tokens / (s["ms"] / 1e3) for s in got[0]["steps"]],
        collectives=[{"coords": g["coords"], "steps": [s["collectives"] for s in g["steps"]]}
                     for g in got],
        state_bytes=[g["state_bytes"] for g in got], init_s=[g["init_s"] for g in got],
        init_peak_bytes=[g["init_peak_bytes"] for g in got],
        peak_bytes=[g["peak_bytes"] for g in got])), flush=True)
