"""Rank functions of the decode ring's mesh tests (``test_torch_ring_mesh.py``)
and of the ring's NCCL cases in ``test_torch_nccl_cuda.py``, run by
``parallel.launch.spawn_ranks`` in processes of their own. Imports torch
and the port only: a spawned rank never imports jax.

Every rank drives its own engine through the same host steps on the same
requests, with a counter clock (the ring's self-gate and the deadline
budget then read no wall clock, so every rank makes the same decisions
and the steps' collectives pair up)."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.ops import moe
from omnia_tpu_torch.parallel.collectives import all_gather
from omnia_tpu_torch.parallel.distributed import GRAPH_MIXING
from omnia_tpu_torch.parallel.mesh import capture_comms, make_mesh
from omnia_tpu_torch.parallel.pipeline import pipeline_forward
from omnia_tpu_torch.train import trainer
from torch_dpsp_workers import _counter_clock
from torch_pp_workers import _grads, _held

# The 32-token bucket reaches long_prefill_threshold: under sp a prompt
# of 9 or more tokens prefills as the sp ring attention.
RING_BASE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 32), dtype="float32",
                 max_sessions=0, long_prefill_threshold=32, decode_ring=2)
# 18 pages of 16 rows: each dp shard's 2 slots x 64 rows and its trash page.
CACHES = {"contiguous": dict(), "int8_paged": dict(kv_quant="int8", kv_pages=18,
                                                    kv_page_tokens=16)}
# Each case's port mesh. "tp2" is tp = 2 with its sp axis a replica: its
# threshold lies past every bucket, so no prompt takes the sp ring and
# each sp rank serves the tp = 2 engine's steps alone.
MESHES = {"tp2": dict(sp=2, tp=2, long_prefill_threshold=1 << 20),
          "dp2_tp2": dict(dp=2, tp=2), "sp2_tp2": dict(sp=2, tp=2)}
# Greedy requests of different lengths, so that chunks exit early; the
# 20-token prompt takes the sp ring under sp.
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6] + list(range(30, 47)), [5, 3, 5, 8, 9, 7], [2, 7, 1, 8])
MAX_TOKENS = (3, 11, 7, 13)
# The dp case: requests are placed one per step, each behind one decode
# step, into slots 0-3; slots 0 and 1 (shard 0) finish in the first chunk
# after the last placement while slots 2 and 3 (shard 1) run on; then one
# unseeded request lands on slot 0, whose sampler key every executed step
# advanced.
DP_BATCH = ([[4, 4, 2], [6, 1], [7, 7, 7, 3], [1, 2, 3, 4, 5]],
            [dict(temperature=0.8, max_tokens=6), dict(temperature=0.8, max_tokens=6, seed=9),
             dict(temperature=0.8, max_tokens=20), dict(temperature=0.0, max_tokens=20)])
DP_LATE = ([8, 1, 8], dict(temperature=0.8, max_tokens=6))
RING_BOOKS = ("decode_steps", "early_exit_steps", "tokens_generated", "requests_finished")
# The MoE ring at tp = 4 (test-tiny-moe, E = 8, 4 KV heads: one a rank,
# two experts a rank): a 64-row bucket, so that the 40-token prompt's
# prefill takes the capacity dispatch and the decode steps the all-expert
# path.
MOE_RING = dict(max_seq=128, prefill_buckets=(8, 32, 64))
MOE_RING_PROMPTS = (PROMPTS[0], list(range(40, 80)), PROMPTS[2], PROMPTS[3])
# The MoE ring at dp = 2 x tp = 2 with 64 slots, 32 a shard (test-tiny-moe,
# E = 8, the skewed router): every decode step is 64 global rows, the
# capacity dispatch with C = 32, its counts all-gathered over dp. 40
# greedy requests of 2-8 tokens, 40-49 new tokens each: all 40 are live
# at once, so slots 32-39 (shard 1) decode behind shard 0's 32 rows, and
# expert 0 drops live rows of theirs.
MOE_DP_RING_SLOTS, MOE_DP_RING_REQUESTS = 64, 40


def moe_dp_ring_requests(vocab: int) -> tuple:
    """(prompts, sampling kwargs) of the MoE dp ring case."""
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, vocab, 2 + i % 7)]
               for i in range(MOE_DP_RING_REQUESTS)]
    return prompts, [dict(temperature=0.0, max_tokens=40 + i % 10)
                     for i in range(MOE_DP_RING_REQUESTS)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def _drain(eng) -> None:
    while eng.step():
        pass


def serve(eng, prompts, params) -> list:
    """Requests submitted together, stepped to the end: (tokens, finish
    reason) each."""
    hs = [eng.submit(list(p), SamplingParams(**kw)) for p, kw in zip(prompts, params)]
    _drain(eng)
    out = []
    for h in hs:
        toks, fin = h.collect_tokens(timeout=60)
        out.append((toks, fin.finish_reason.value))
    return out


def greedy_params() -> list:
    return [dict(temperature=0.0, max_tokens=n) for n in MAX_TOKENS]


def ring_engine(cfg, tree, device, **fields):
    eng = InferenceEngine(cfg, EngineConfig(**{**RING_BASE, **fields}),
                          params=params_from_jax(tree, device) if tree is not None else None,
                          seed=0, device=device)
    eng.clock = _counter_clock()
    return eng


def dp_script(eng) -> dict:
    """DP_BATCH, then DP_LATE alone: the tokens, every slot's sampler
    state after the batch (gathered over dp), the slots the requests took
    and the ring's books."""
    hs = [eng.submit(list(p), SamplingParams(**kw)) for p, kw in zip(*DP_BATCH)]
    slots = []
    while eng.step():
        slots = slots or ([s.request.request_id for s in eng._slots]
                          if all(s.active for s in eng._slots) else [])
    batch = [(t, f.finish_reason.value) for t, f in (h.collect_tokens(timeout=60) for h in hs)]
    keys = _np(eng._dp.gather(eng._key_data, dim=0))
    late = serve(eng, [DP_LATE[0]], [DP_LATE[1]])
    eng.stop()
    return dict(batch=batch, late=late, keys=keys, slots=[h.request_id for h in hs] == slots,
                books={k: eng.metrics[k] for k in RING_BOOKS})


def refusals(cfg) -> dict:
    """On a gloo job, an engine on the card (the device patched to CUDA:
    the refusal comes before any CUDA call) with the decode ring at dp or
    tp above 1 must raise; sp alone must pass the check."""
    from omnia_tpu_torch.engine import engine as engine_mod

    cuda = torch.device("cuda")
    out = {}
    real = engine_mod.resolve_device
    engine_mod.resolve_device = lambda device=None: cuda
    try:
        for name, dims in (("dp2_tp2", dict(dp=2, tp=2)), ("sp2_tp2", dict(sp=2, tp=2)),
                           ("dp2_sp2", dict(dp=2, sp=2))):
            try:
                InferenceEngine(cfg, EngineConfig(**{**RING_BASE, **dims}), device="cuda")
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    finally:
        engine_mod.resolve_device = real
    engine_mod.validate_parallel(EngineConfig(**{**RING_BASE, "sp": 4}), cfg, cuda)
    out["sp4_allowed"] = True
    # On NCCL the captured collectives need NCCL's graph mixing off.
    backend, mixing = engine_mod.dist.get_backend, os.environ.pop(GRAPH_MIXING, None)
    engine_mod.dist.get_backend = lambda *a: "nccl"
    try:
        ecfg = EngineConfig(**{**RING_BASE, "dp": 2, "tp": 2})
        try:
            engine_mod.validate_parallel(ecfg, cfg, cuda)
            out["mixing_on"] = None
        except ValueError as e:
            out["mixing_on"] = str(e)
        os.environ[GRAPH_MIXING] = "0"
        engine_mod.validate_parallel(ecfg, cfg, cuda)
        out["mixing_off_allowed"] = True
    finally:
        engine_mod.dist.get_backend = backend
        os.environ.pop(GRAPH_MIXING, None)
        if mixing is not None:
            os.environ[GRAPH_MIXING] = mixing
    return out


def capture_lines(rank: int) -> dict:
    """At dp = 2 x tp = 2: per axis, the job ranks of this rank's line on
    the mesh's group and on its capture group (an all-gather of each
    rank's id over each)."""
    mesh = make_mesh(dp=2, tp=2)
    me = torch.tensor([[rank]])
    return {axis: (all_gather(me, mesh.comm(axis), dim=0).flatten().tolist(),
                   all_gather(me, comm, dim=0).flatten().tolist(),
                   comm.group is not mesh.comm(axis).group)
            for axis, comm in capture_comms(mesh).items()}


@contextlib.contextmanager
def recorded_routes():
    """Yields the list that every MoE layer's routing appends its top-k
    ids to ([rows, k] each, in call order), while the block runs."""
    routes: list = []
    real = moe.route_sparse

    def recorded(h, router_w, k):
        top_w, top_i = real(h, router_w, k)
        routes.append(_np(top_i).reshape(-1, k))
        return top_w, top_i

    moe.route_sparse = recorded
    try:
        yield routes
    finally:
        moe.route_sparse = real


def moe_case(rank: int, case: dict) -> dict:
    """The MoE dp repair at dp = 2 x tp = 2: the forward of each shape
    over this shard's rows, logits gathered whole, and the routes every
    layer took (this shard's top-k ids); then one train_step on the
    4-row batch and one on the 3-row one (uneven over dp), each its loss
    and gradient gathered whole, and its routes (padding rows' too)."""
    cfg = get_config(**case["cfg"])
    mesh = make_mesh(dp=2, tp=2)
    tp, dp = mesh.comm("tp"), mesh.comm("dp")
    out = {}
    with recorded_routes() as routes:
        params = params_from_jax(case["tree"], "cpu", mesh=mesh, cfg=cfg)
        for tokens in case["forwards"]:
            B, T = tokens.shape
            rows = slice(dp.index * B // 2, (dp.index + 1) * B // 2)
            ck, cv = llama.init_kv_cache(cfg, B // 2, T + 7, "cpu", dtype=torch.float32, tp=2)
            pos = torch.arange(T, dtype=torch.int32).expand(B // 2, T)
            routes.clear()
            with torch.no_grad():
                lg, _, _ = llama.forward(params, cfg, torch.from_numpy(tokens[rows]), pos, ck,
                                         cv, torch.zeros(B // 2, dtype=torch.int32), tp, dp)
            whole = all_gather(all_gather(lg, tp, dim=-1), dp, dim=0)
            out[(B, T)] = dict(logits=_np(whole), routes=list(routes))
        routes.clear()
        init_fn, step = trainer.make_train_step(cfg, trainer.adamw(1e-2), mesh=mesh,
                                                device="cpu")
        for name in ("train", "train_uneven"):
            routes.clear()
            state = init_fn(params=params_from_jax(case["tree"], "cpu", mesh=mesh, cfg=cfg))
            state, loss = step(state, case[f"{name}_tokens"])
            grads, _ = _held(rank, _grads(state.params), llama.param_specs(cfg), mesh)
            out[name] = dict(loss=float(loss), routes=list(routes), grads=grads)
    return out


def moe_pp_case(rank: int, case: dict) -> dict:
    """The MoE dp repair inside the pipeline at pp = 2 x dp = 2, per
    microbatch count M of ``case["pp"]``: ``pipeline_forward``'s logits
    and ``pipeline_loss_fn``'s loss and gradient gathered whole, each with
    the routes this rank's layers took; and this rank's mesh
    coordinates."""
    cfg = get_config(**case["cfg"])
    mesh = make_mesh(dp=2, pp=2)
    out = dict(coords=mesh.coords)
    for m, (forward_tokens, train_tokens) in case["pp"].items():
        params = params_from_jax(case["tree"], "cpu", mesh=mesh, cfg=cfg)
        tok = torch.from_numpy(forward_tokens)
        pos = torch.arange(tok.shape[1], dtype=torch.int32).expand_as(tok)
        with recorded_routes() as routes, torch.no_grad():
            logits, _, _ = pipeline_forward(params, cfg, tok, pos, mesh, m)
        res = dict(forward=dict(logits=_np(logits), routes=routes))
        for _, p in trainer.leaves(params):
            p.requires_grad_(True)
        with recorded_routes() as routes:
            loss = trainer.pipeline_loss_fn(params, cfg, torch.from_numpy(train_tokens), mesh, m)
        loss.backward()
        grads, _ = _held(rank, _grads(params), llama.mesh_param_specs(cfg, mesh), mesh)
        res["train"] = dict(loss=float(loss), routes=routes, grads=grads)
        out[m] = res
    return out


def moe_ring_case(rank: int, case: dict) -> dict:
    """The MoE decode ring at tp = 4: ring on (the eager ring on the CPU)
    and off serve MOE_RING_PROMPTS greedily; (tokens, finish) rows each."""
    cfg = get_config(**case["ring_cfg"])
    out = {}
    for arm, ring in (("on", 2), ("off", 0)):
        eng = ring_engine(cfg, case["ring_tree"], "cpu", tp=4, decode_ring=ring, **MOE_RING)
        out[arm] = serve(eng, MOE_RING_PROMPTS, greedy_params())
        eng.stop()
    return out


@contextlib.contextmanager
def counted_dispatch():
    """Yields the list that every ``moe_dispatch`` call appends to while the
    block runs: its (B, T), the all-gathers its dp Comm took during the
    call, and its routes' top-k ids [B·T, k]."""
    calls: list = []
    real = moe.moe_dispatch

    def gathers(dp) -> int:
        return dp.op_stats.get("all_gather", {}).get("calls", 0) if hasattr(dp, "op_stats") else 0

    def counted(h, p, k, capacity_factor=2.0, comm=None, dp=None):
        n = gathers(dp)
        out = real(h, p, k, capacity_factor, comm=comm, dp=dp)
        _, top_i = moe.route_sparse(h.reshape(-1, h.shape[-1]), p["router"], k)
        calls.append(dict(shape=tuple(h.shape[:2]), gathers=gathers(dp) - n, top_i=_np(top_i)))
        return out

    moe.moe_dispatch = counted
    try:
        yield calls
    finally:
        moe.moe_dispatch = real


def moe_dp_ring_case(rank: int, case: dict) -> dict:
    """The MoE decode ring at dp = 2 x tp = 2 with MOE_DP_RING_SLOTS slots
    (half on each shard): every decode step is that many global rows, so each
    MoE layer takes the capacity dispatch over the whole batch. The
    greedy (tokens, finish) rows of MOE_DP_RING_REQUESTS, the ring's books,
    and the decode steps' dispatch calls (this shard's [B, 1] calls:
    their all-gathers and routes)."""
    cfg = get_config(**case["cfg"])
    eng = ring_engine(cfg, case["tree"], "cpu", dp=2, tp=2, num_slots=MOE_DP_RING_SLOTS)
    prompts, params = moe_dp_ring_requests(cfg.vocab_size)
    with counted_dispatch() as calls:
        rows = serve(eng, prompts, params)
    eng.stop()
    local = MOE_DP_RING_SLOTS // 2
    steps = [c for c in calls if c["shape"] == (local, 1)]
    return dict(rows=rows, books={k: eng.metrics[k] for k in RING_BOOKS},
                gathers=[c["gathers"] for c in steps], routes=[c["top_i"] for c in steps],
                layers=cfg.num_layers)


def ring_mesh_job(rank: int, tree, moe_case_args: dict) -> dict:
    """On four gloo ranks: per mesh of ``MESHES`` and cache of ``CACHES``
    the ring engine's greedy (tokens, finish) rows; the dp script on a dp
    = 2 x tp = 2 ring engine and on a dp = tp = 1 one; the refusals; the
    MoE dp repair, outside the pipeline and inside it; the MoE ring at
    tp = 4."""
    torch.set_num_threads(1)
    cfg = get_config("test-tiny")
    out = {"ring": {}}
    for name, dims in MESHES.items():
        for cache, fields in CACHES.items():
            eng = ring_engine(cfg, tree, "cpu", **dims, **fields)
            out["ring"][(name, cache)] = dict(
                rows=serve(eng, PROMPTS, greedy_params()),
                books={k: eng.metrics[k] for k in RING_BOOKS},
                local_slots=int(eng._tokens.shape[0]))
            eng.stop()
    out["dp"] = dp_script(ring_engine(cfg, tree, "cpu", dp=2, tp=2))
    out["dp1"] = dp_script(ring_engine(cfg, tree, "cpu"))
    out["refusals"] = refusals(cfg)
    out["capture_lines"] = capture_lines(rank)
    out["moe"] = moe_case(rank, moe_case_args)
    out["moe_pp"] = moe_pp_case(rank, moe_case_args)
    out["moe_ring"] = moe_ring_case(rank, moe_case_args)
    out["moe_dp_ring"] = moe_dp_ring_case(rank, moe_case_args)
    return out


# -- test_torch_nccl_cuda.py -----------------------------------------------

# The job's environment: the decode ring under tp or dp on the card is
# opt-in through NCCL's graph-mixing switch (engine.validate_parallel).
NCCL_RING_ENV = {GRAPH_MIXING: "0"}


def rank_env(manifest_dir, ring: bool = False) -> dict:
    """A test spawn's environment: the ranks' warmup manifests under
    ``manifest_dir``, never in the kernel build cache
    (``engine/coldstart.py``); with ``ring`` also NCCL_RING_ENV."""
    return {"OMNIA_WARMUP_MANIFEST_DIR": str(manifest_dir), **(NCCL_RING_ENV if ring else {})}


def warm_job(rank: int) -> dict:
    """test-tiny at tp = 2 on this CPU rank, warmed through LockstepEngine:
    the manifest directory the engine used and its warmed programs."""
    from omnia_tpu_torch.engine import coldstart
    from omnia_tpu_torch.engine.multihost import LockstepEngine

    eng = InferenceEngine(get_config("test-tiny"),
                          EngineConfig(num_slots=2, max_seq=64, prefill_buckets=(16,),
                                       dtype="float32", max_sessions=0, tp=2),
                          seed=3, device="cpu")
    LockstepEngine(eng).warmup()
    return dict(manifest_dir=coldstart.manifest_dir(),
                programs=eng.metrics["warmup_programs_done"])

NCCL_RING_ENGINE = dict(num_slots=4, max_seq=128, prefill_buckets=(16, 32), decode_chunk=4,
                        dtype="float32", max_sessions=0, long_prefill_threshold=32)
# 34 pages of 16 rows: each dp shard's 2 slots x 128 rows and its trash page.
NCCL_RING_CACHES = {"K1": dict(), "K4": dict(kv_quant="int8", kv_pages=34, kv_page_tokens=16)}
# -- the whole models over NCCL -------------------------------------------
#
# Each case: (1) the model's full width cut to WIDTH_CHECK_LAYERS layers,
# f32, TF32 off, on the case's mesh against one card (``_width_check``);
# (2) the whole model in bf16, ring on and off over the same weights, the
# requests in alternating windows (``_serve_whole``).
WIDTH_CHECK_LAYERS, WIDTH_CHECK_LOGITS_TOL, WIDTH_CHECK_NEW_TOKENS = 2, 1e-3, 12
WIDTH_CHECK_ENGINE = dict(max_seq=256, prefill_buckets=(32, 64, 128, 256), dtype="float32",
                          max_sessions=0)
WIDTH_CHECK_PROMPT_LENGTHS = (17, 64, 100, 200)
# chip_smoke.py's burst lengths (phase 5).
BURST_LENGTHS = (17, 900, 64, 333, 128, 511, 45, 700, 250, 31, 600, 100)
# llama3-8b at tp = 2: chip_smoke.py's 12-request burst.
NCCL_8B_SEED, NCCL_8B_WINDOWS = 27, 3
# The whole Mixtral-8x7B at tp = 4 (two experts and two KV heads a rank):
# (1) a prefill of 8 rows x 8 tokens (64 rows: the capacity dispatch), then
# one decode step of 8 rows (the all-expert path, on K1); a tp = 4 engine
# of 8 slots; (2) the 12-request burst.
NCCL_MIXTRAL_TP, NCCL_MIXTRAL_SEED, NCCL_MIXTRAL_WINDOWS = 4, 31, 3
NCCL_MIXTRAL_CHECK_SHAPES = ((8, 9),)
# Mixtral-8x7B at dp = 2 x tp = 2 (four experts and four KV heads a rank,
# 32 slots a dp shard): every decode step is 64 global rows, so it takes
# the capacity dispatch (C = 32) with its counts all-gathered over dp in
# the ring's captured step. (1) the [8, 8] prefill (64 rows) and its
# 8-row step, a [64, 1] prefill and its 64-row step; an engine of 64
# slots; (2) 64 requests of BURST_LENGTHS repeated, 64 new tokens each,
# even ones greedy, odd ones sampled.
NCCL_MOE_DP, NCCL_MOE_DP_SEED, NCCL_MOE_DP_WINDOWS = dict(dp=2, tp=2), 33, 3
NCCL_MOE_DP_SLOTS, NCCL_MOE_DP_NEW_TOKENS = 64, 64
NCCL_MOE_DP_CHECK_SHAPES = ((8, 9), (64, 2))
# Llama-3-70B at tp = 4 (16 query heads and 2 KV heads a rank), batch-eval
# traffic: (1) a [32, 8] prefill and its 32-row step; an engine of 8 slots;
# (2) one burst of 32 greedy requests of 128-958 tokens (each makes its 64
# new tokens inside max_seq 1024), ring on in three windows, ring off in
# one (a ring-off step launches every kernel of 80 layers from Python).
NCCL_70B_TP, NCCL_70B_SEED, NCCL_70B_WINDOWS = 4, 35, {"on": 3, "off": 1}
NCCL_70B_SLOTS, NCCL_70B_NEW_TOKENS = 32, 64
NCCL_70B_CHECK_SHAPES = ((32, 9),)


def _counted_serve(eng, prompts, params) -> dict:
    """``serve`` with the decode-attention launches counted on the card
    (set to 0 just before, read just after) beside the steps that ran
    (dispatched less the ring's early exits)."""
    from omnia_tpu_torch.ops import decode_attention as da

    torch.cuda.synchronize()
    da.reset_launches()
    m0 = dict(eng.metrics)
    rows = serve(eng, prompts, params)
    counted = da.launches()
    ran = ((eng.metrics["decode_steps"] - m0["decode_steps"])
           - (eng.metrics["early_exit_steps"] - m0["early_exit_steps"]))
    return dict(rows=rows, launches=counted, ran=ran, edition=eng._kernel_edition(),
                layers=eng.model_cfg.num_layers)


def nccl_ring_job(rank: int, dims: dict) -> dict:
    """The decode ring over NCCL, one rank per card, test-tiny-gqa8 f32 on
    ``make_mesh(**dims)``: per cache (K1, K4) a warmed ring engine (its
    graphs captured, their steps holding the tp and dp collectives) and a
    ring-off one serve the greedy requests with the launches counted on
    the card; rank 0 also serves them on a one-rank ring-off engine. Under
    dp, the dp script on a dp x tp ring engine and on this rank's dp = 1
    ring engine."""
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    cfg = get_config("test-tiny-gqa8")
    out = dict(backend=torch.distributed.get_backend(), device=str(dev))
    for label, fields in NCCL_RING_CACHES.items():
        for arm, ring in (("on", 2), ("off", 0)):
            eng = InferenceEngine(cfg, EngineConfig(**NCCL_RING_ENGINE, **fields, **dims,
                                                    decode_ring=ring), seed=3)
            eng.clock = _counter_clock()
            eng.warmup()
            res = _counted_serve(eng, PROMPTS, greedy_params())
            graphs = eng._ring_graphs
            res.update(captured=graphs is not None and sorted(graphs.capture_s),
                       step_collectives=graphs.step_collectives if graphs else None,
                       device=str(eng.device))
            out[(label, arm)] = res
            eng.stop()
            del eng, graphs
        if rank == 0:
            ref = InferenceEngine(cfg, EngineConfig(**NCCL_RING_ENGINE, **fields), seed=3)
            out[(label, "tp1")] = serve(ref, PROMPTS, greedy_params())
    if dims.get("dp", 1) > 1:
        base = get_config("test-tiny")
        out["dp"] = dp_script(ring_engine(base, None, dev, **dims))
        out["dp1"] = dp_script(ring_engine(base, None, dev))
    return out


def burst_requests(vocab: int, n: int, new_tokens: int) -> list:
    """n requests of BURST_LENGTHS repeated, ``new_tokens`` each: even ones
    greedy, odd ones sampled (chip_smoke.py's sampler, seeded)."""
    rng = np.random.default_rng(42)
    reqs = []
    for i in range(n):
        prompt = [int(t) for t in rng.integers(0, vocab, BURST_LENGTHS[i % len(BURST_LENGTHS)])]
        sp = (SamplingParams(temperature=0.0, max_tokens=new_tokens) if i % 2 == 0
              else SamplingParams(temperature=0.7, top_p=0.9, top_k=40, max_tokens=new_tokens,
                                  seed=100 + i))
        reqs.append((prompt, sp))
    return reqs


def batch_eval_requests(vocab: int, n: int, new_tokens: int, max_seq: int) -> list:
    """n greedy requests of 128 tokens up to the longest prompt that still
    makes ``new_tokens`` inside ``max_seq`` (its last two rows unused)."""
    rng = np.random.default_rng(43)
    lengths = np.linspace(128, max_seq - 2 - new_tokens, n).astype(int)
    return [([int(t) for t in rng.integers(0, vocab, int(m))],
             SamplingParams(temperature=0.0, max_tokens=new_tokens)) for m in lengths]


def _forward_rows(params, cfg, tokens: np.ndarray, dev, mesh) -> np.ndarray:
    """A prefill of tokens[:, :-1] into a fresh cache, then one decode step
    of tokens[:, -1:] (on the card K1): the prefill's last row's and the
    step's logits [B, 2, V], gathered whole. On a ``mesh`` this rank runs
    its dp shard's block of the rows (an MoE layer branching and dropping
    over the whole batch) with its tp slice; with None, one card."""
    tp = dp = None
    rows = slice(None)
    if mesh is not None:
        tp, dp = mesh.comm("tp"), mesh.comm("dp")
        if dp is not None:
            n = tokens.shape[0] // dp.size
            rows = slice(dp.index * n, (dp.index + 1) * n)
    tok = torch.from_numpy(tokens[rows]).to(dev)
    B, T = tok.shape[0], tok.shape[1] - 1
    ck, cv = llama.init_kv_cache(cfg, B, 2 * T, dev, dtype=torch.float32,
                                 tp=1 if tp is None else tp.size)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    with torch.no_grad():
        lg, _, _ = llama.forward(params, cfg, tok[:, :T], pos, ck, cv,
                                 torch.zeros(B, dtype=torch.int32, device=dev), tp, dp)
        step = torch.full((B, 1), T, dtype=torch.int32, device=dev)
        lg1, _, _ = llama.forward(params, cfg, tok[:, T:], step, ck, cv, step[:, 0], tp, dp)
        out = llama.gather_logits(torch.cat([lg[:, -1:], lg1], dim=1), tp)
        return _np(all_gather(out, dp, dim=0))


def overflow(top_i: np.ndarray, E: int) -> int:
    """The assignments past capacity (factor 2) of one dispatch over the
    whole batch's routes top_i [N, K]."""
    N, K = top_i.shape
    capacity = max(1, -(-N * K * 2 // E))
    counts = np.bincount(top_i.reshape(-1), minlength=E)
    return int(np.maximum(counts - capacity, 0).sum())


def _overflow(routes: list, E: int) -> list:
    """Per MoE call of at least DISPATCH_MIN_TOKENS rows (the dispatch
    branch), (rows, the assignments past capacity)."""
    return [(top_i.shape[0], overflow(top_i, E)) for top_i in routes
            if top_i.shape[0] >= moe.DISPATCH_MIN_TOKENS]


def _width_check(rank: int, dev, name: str, dims: dict, shapes, slots: int, seed: int) -> dict:
    """The model's full width cut to WIDTH_CHECK_LAYERS layers, f32, TF32
    off, drawn whole from one seed and cut on every rank (rank 0 also
    draws it whole): ``_forward_rows`` at each of ``shapes`` on
    ``make_mesh(**dims)``, and the greedy tokens of an engine of ``slots``
    slots on that mesh (every rank stepping its own, on a counter clock);
    on rank 0 the one-card forwards (with each dispatch call's drops) and
    a one-card engine of as many slots."""
    cfg = get_config(name, num_layers=WIDTH_CHECK_LAYERS)
    mesh = make_mesh(**dims)
    rng = np.random.default_rng(seed)
    tokens = [rng.integers(0, cfg.vocab_size, s).astype(np.int64) for s in shapes]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, WIDTH_CHECK_PROMPT_LENGTHS[
        i % len(WIDTH_CHECK_PROMPT_LENGTHS)])] for i in range(slots)]
    kw = [dict(temperature=0.0, max_tokens=WIDTH_CHECK_NEW_TOKENS)] * slots
    fields = dict(WIDTH_CHECK_ENGINE, num_slots=slots)

    def draw(mesh):
        return llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                                 dtype=torch.float32, mesh=mesh)

    def greedy(eng):
        eng.clock = _counter_clock()
        rows = [toks for toks, _ in serve(eng, prompts, kw)]
        eng.stop()
        return rows

    params = draw(mesh)
    out = dict(logits=[_forward_rows(params, cfg, t, dev, mesh) for t in tokens],
               experts=int(params["layers"]["mlp"]["wg"].shape[1]) if cfg.is_moe else 0)
    eng = InferenceEngine(cfg, EngineConfig(**fields, **dims), params=params, device=dev)
    out.update(edition=eng._kernel_edition(), slots=eng._dp.per, greedy=greedy(eng))
    del eng, params
    if rank == 0:
        whole = draw(None)
        with recorded_routes() as routes:
            out["logits_tp1"] = [_forward_rows(whole, cfg, t, dev, None) for t in tokens]
        out["dispatch_drops"] = _overflow(routes, cfg.num_experts)
        out["greedy_tp1"] = greedy(InferenceEngine(cfg, EngineConfig(**fields), params=whole,
                                                   device=dev))
        del whole
    return out


def _serve_whole(rank: int, name: str, dims: dict, fields: dict, reqs: list, windows: dict,
                 seed: int) -> dict:
    """The whole ``name`` in bf16, random seeded weights drawn leaf by leaf
    and cut to this rank's slice as each is drawn (``init_params(mesh=)``:
    one whole leaf at most), on ``make_mesh(**dims)`` over NCCL, one rank
    per card: a decode ring engine and a ring-off one over the same
    weights (``EngineConfig(**fields, **dims)``), each warmed, serve
    ``reqs`` through LockstepEngine in alternating windows, ``windows[arm]``
    of each (``_burst_window``). Each rank's params and KV bytes, its
    slots, init / warmup / capture seconds, pool bytes, one captured
    step's collectives, the init's peak and the serving's after it (both
    engines, their graphs and the windows); the leader's greedy tokens per
    arm."""
    import gc
    import time

    from omnia_tpu_torch.engine.multihost import LockstepEngine
    from omnia_tpu_torch.parallel.distributed import rank_device

    dev = rank_device()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(name)
    t0 = time.monotonic()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                               dtype=torch.bfloat16, mesh=make_mesh(**dims))
    torch.cuda.synchronize()
    out = dict(rank=rank, init_s=time.monotonic() - t0,
               init_peak_bytes=torch.cuda.max_memory_allocated(),
               windows={arm: [] for arm in windows})
    torch.cuda.reset_peak_memory_stats()
    engines = {}
    for arm, ring in (("on", 2), ("off", 0)):
        eng = InferenceEngine(cfg, EngineConfig(**fields, **dims, decode_ring=ring),
                              params=params, device=dev)
        t0 = time.monotonic()
        LockstepEngine(eng).warmup()
        out[f"warmup_s_{arm}"] = time.monotonic() - t0
        engines[arm] = eng
    graphs = engines["on"]._ring_graphs
    out.update(capture_s=graphs.capture_s, pool_bytes=graphs.pool_bytes,
               step_collectives=graphs.step_collectives,
               params_bytes=sum(t.numel() * t.element_size()
                                for _, t in trainer.leaves(params)),
               kv_bytes=engines["on"].metrics["kv_quant_device_bytes"],
               slots=engines["on"]._dp.per, layers=cfg.num_layers,
               edition=engines["on"]._kernel_edition())
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0.0]
    tokens = {}
    for i in range(max(windows.values())):
        for arm, eng in engines.items():
            if i < windows[arm]:
                window, toks = _burst_window(eng, reqs, LockstepEngine)
                out["windows"][arm].append(window)
                if toks is not None:
                    tokens.setdefault(arm, [toks[j] for j in greedy])
    out["greedy"] = tokens or None
    out["serving_peak_bytes"] = torch.cuda.max_memory_allocated()
    for eng in engines.values():
        eng.stop()
    return out


def nccl_8b_job(rank: int) -> dict:
    """llama3-8b at full depth in bf16, tp = 2 over NCCL, one rank per
    card: ``_serve_whole`` on chip_smoke.py's 12-request burst (phase 5's).
    Per window the leader's host ms per decode step, and on every rank the
    decode chunks' device time (CUDA events around each chunk's enqueue)
    over the window's wall."""
    import chip_smoke

    reqs = chip_smoke.burst(get_config("llama3-8b").vocab_size, 12)
    return _serve_whole(rank, "llama3-8b", dict(tp=2), {}, reqs,
                        {"on": NCCL_8B_WINDOWS, "off": NCCL_8B_WINDOWS}, NCCL_8B_SEED)


def nccl_mixtral_job(rank: int) -> dict:
    """The whole Mixtral-8x7B at tp = 4 over NCCL, one rank per card, on
    random seeded weights: (1) ``_width_check`` (the [8, 8] prefill and an
    8-row step, an engine of 8 slots); (2) ``_serve_whole`` on
    chip_smoke.py's 12-request burst, with the decode-attention launches
    counted on the card per window."""
    import chip_smoke
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dims = dict(tp=NCCL_MIXTRAL_TP)
    check = _width_check(rank, rank_device(), "mixtral-8x7b", dims, NCCL_MIXTRAL_CHECK_SHAPES, 8,
                         NCCL_MIXTRAL_SEED)
    reqs = chip_smoke.burst(get_config("mixtral-8x7b").vocab_size, 12)
    out = _serve_whole(rank, "mixtral-8x7b", dims, {}, reqs,
                       {"on": NCCL_MIXTRAL_WINDOWS, "off": NCCL_MIXTRAL_WINDOWS},
                       NCCL_MIXTRAL_SEED)
    return dict(out, check=check)


def nccl_moe_dp_job(rank: int) -> dict:
    """Mixtral-8x7B at dp = 2 x tp = 2 over NCCL, one rank per card, every
    decode step 64 global rows through the capacity dispatch: (1)
    ``_width_check`` at NCCL_MOE_DP_CHECK_SHAPES with an engine of 64 slots
    against one card's of 64 (the same dispatch over the same N, so the
    same drops); (2) ``_serve_whole`` with 64 slots and max_seq 1024 on 64
    ``burst_requests``."""
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    check = _width_check(rank, rank_device(), "mixtral-8x7b", NCCL_MOE_DP,
                         NCCL_MOE_DP_CHECK_SHAPES, NCCL_MOE_DP_SLOTS, NCCL_MOE_DP_SEED)
    reqs = burst_requests(get_config("mixtral-8x7b").vocab_size, NCCL_MOE_DP_SLOTS,
                          NCCL_MOE_DP_NEW_TOKENS)
    out = _serve_whole(rank, "mixtral-8x7b", NCCL_MOE_DP,
                       dict(num_slots=NCCL_MOE_DP_SLOTS, max_seq=1024), reqs,
                       {"on": NCCL_MOE_DP_WINDOWS, "off": NCCL_MOE_DP_WINDOWS}, NCCL_MOE_DP_SEED)
    return dict(out, check=check)


def nccl_70b_job(rank: int) -> dict:
    """Llama-3-70B at tp = 4 over NCCL, one rank per card: (1)
    ``_width_check`` (a [32, 8] prefill and its 32-row step, an engine of
    8 slots); (2) ``_serve_whole`` with 32 slots and max_seq 1024 on 32
    ``batch_eval_requests``, ring on in three windows, off in one."""
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dims = dict(tp=NCCL_70B_TP)
    check = _width_check(rank, rank_device(), "llama3-70b", dims, NCCL_70B_CHECK_SHAPES, 8,
                         NCCL_70B_SEED)
    fields = dict(num_slots=NCCL_70B_SLOTS, max_seq=1024)
    reqs = batch_eval_requests(get_config("llama3-70b").vocab_size, NCCL_70B_SLOTS,
                               NCCL_70B_NEW_TOKENS, fields["max_seq"])
    out = _serve_whole(rank, "llama3-70b", dims, fields, reqs, NCCL_70B_WINDOWS, NCCL_70B_SEED)
    return dict(out, check=check)


def _burst_window(eng, reqs, lockstep_cls) -> tuple:
    """One burst through a LockstepEngine (the leader submits every request
    before its loop starts, so the ticks carry them alike in every window;
    the others replicate), every decode chunk's enqueue between CUDA
    events, the decode-attention launches counted on the card (set to 0
    just before, read just after) beside the steps that ran: (the window's
    numbers, the leader's tokens per request or None)."""
    import time

    from omnia_tpu_torch.ops import decode_attention as da

    pairs = []
    run_step = eng._run_decode_step

    def timed(chunk, dl_steps=None):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        toks = run_step(chunk, dl_steps)
        e1.record()
        pairs.append((e0, e1))
        return toks

    eng._run_decode_step = timed
    lock = lockstep_cls(eng)
    m0 = dict(eng.metrics)
    toks = None
    torch.distributed.barrier()
    torch.cuda.synchronize()
    da.reset_launches()
    t0 = time.monotonic()
    try:
        if lock.is_leader:
            hs = [lock.submit(p, sp) for p, sp in reqs]
            lock.start()
            try:
                toks = [h.collect_tokens(timeout=600)[0] for h in hs]
            finally:
                lock.stop()
        else:
            lock.run_follower()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    finally:
        del eng._run_decode_step
    launches = da.launches()
    m = eng.metrics
    steps = m["decode_steps"] - m0["decode_steps"]
    early = m["early_exit_steps"] - m0["early_exit_steps"]
    host_s = sum(m[k] - m0[k] for k in ("decode_dispatch_s", "decode_sync_s"))
    chunk_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return dict(decode_steps=steps, early_exit_steps=early, ran=steps - early,
                launches=launches, host_ms_per_decode_step=host_s / max(steps, 1) * 1e3,
                wall_s=wall_s, chunk_device_ms=chunk_ms,
                chunk_device_ms_per_step=chunk_ms / max(steps - early, 1),
                chunk_device_share=chunk_ms / (wall_s * 1e3)), toks
