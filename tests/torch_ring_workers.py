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
    layer took (this shard's top-k ids); then one train_step, its loss
    and gradient gathered whole, and its routes."""
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
        state = init_fn(params=params_from_jax(case["tree"], "cpu", mesh=mesh, cfg=cfg))
        state, loss = step(state, case["train_tokens"])
        grads, _ = _held(rank, _grads(state.params), llama.param_specs(cfg), mesh)
        out["train"] = dict(loss=float(loss), routes=list(routes), grads=grads)
    return out


def moe_pp_case(rank: int, case: dict) -> dict:
    """The MoE dp repair inside the pipeline at pp = 2 x dp = 2, M = 2:
    ``pipeline_forward``'s logits and ``pipeline_loss_fn``'s loss and
    gradient gathered whole, each with the routes this rank's layers
    took, and this rank's mesh coordinates."""
    cfg = get_config(**case["cfg"])
    mesh = make_mesh(dp=2, pp=2)
    out = dict(coords=mesh.coords)
    params = params_from_jax(case["tree"], "cpu", mesh=mesh, cfg=cfg)
    tok = torch.from_numpy(case["pp_tokens"])
    pos = torch.arange(tok.shape[1], dtype=torch.int32).expand_as(tok)
    with recorded_routes() as routes, torch.no_grad():
        logits, _, _ = pipeline_forward(params, cfg, tok, pos, mesh, 2)
    out["forward"] = dict(logits=_np(logits), routes=routes)
    for _, p in trainer.leaves(params):
        p.requires_grad_(True)
    with recorded_routes() as routes:
        loss = trainer.pipeline_loss_fn(params, cfg, torch.from_numpy(case["pp_train_tokens"]),
                                        mesh, 2)
    loss.backward()
    grads, _ = _held(rank, _grads(params), llama.mesh_param_specs(cfg, mesh), mesh)
    out["train"] = dict(loss=float(loss), routes=routes, grads=grads)
    return out


def ring_mesh_job(rank: int, tree, moe_case_args: dict) -> dict:
    """On four gloo ranks: per mesh of ``MESHES`` and cache of ``CACHES``
    the ring engine's greedy (tokens, finish) rows; the dp script on a dp
    = 2 x tp = 2 ring engine and on a dp = tp = 1 one; the refusals; the
    MoE dp repair, outside the pipeline and inside it."""
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
    return out


# -- test_torch_nccl_cuda.py -----------------------------------------------

# The job's environment: the decode ring under tp or dp on the card is
# opt-in through NCCL's graph-mixing switch (engine.validate_parallel).
NCCL_RING_ENV = {GRAPH_MIXING: "0"}

NCCL_RING_ENGINE = dict(num_slots=4, max_seq=128, prefill_buckets=(16, 32), decode_chunk=4,
                        dtype="float32", max_sessions=0, long_prefill_threshold=32)
# 34 pages of 16 rows: each dp shard's 2 slots x 128 rows and its trash page.
NCCL_RING_CACHES = {"K1": dict(), "K4": dict(kv_quant="int8", kv_pages=34, kv_page_tokens=16)}
# llama3-8b at tp = 2: the burst's windows, ring on and off in turns.
NCCL_8B_SEED, NCCL_8B_WINDOWS = 27, 3


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


def nccl_8b_job(rank: int) -> dict:
    """llama3-8b at full depth in bf16, random seeded weights, tp = 2 over
    NCCL, one rank per card: a decode ring engine and a ring-off one over
    the same weights, each warmed, serve chip_smoke.py's 12-request burst
    (phase 5's) through LockstepEngine in alternating windows. Per window
    the leader's host ms per decode step, and on every rank the decode
    chunks' device time (CUDA events around each chunk's enqueue) over the
    window's wall; the greedy requests' tokens; each rank's params and KV
    bytes, the capture's seconds and pool bytes and one captured step's
    collectives."""
    import time

    import chip_smoke
    from omnia_tpu_torch.engine.multihost import LockstepEngine
    from omnia_tpu_torch.parallel.distributed import rank_device

    dev = rank_device()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(tp=2)
    cfg = get_config("llama3-8b")
    t0 = time.monotonic()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(NCCL_8B_SEED), dev,
                               dtype=torch.bfloat16, mesh=mesh)
    engines, out = {}, dict(rank=rank, init_s=time.monotonic() - t0, windows={"on": [], "off": []})
    for arm, ring in (("on", 2), ("off", 0)):
        eng = InferenceEngine(cfg, EngineConfig(tp=2, decode_ring=ring), params=params,
                              device=dev)
        t0 = time.monotonic()
        LockstepEngine(eng).warmup()
        out[f"warmup_s_{arm}"] = time.monotonic() - t0
        engines[arm] = eng
    graphs = engines["on"]._ring_graphs
    out.update(capture_s=graphs.capture_s, pool_bytes=graphs.pool_bytes,
               step_collectives=graphs.step_collectives,
               params_bytes=sum(t.numel() * t.element_size()
                                for _, t in trainer.leaves(params)),
               kv_bytes=engines["on"].metrics["kv_quant_device_bytes"])
    reqs = chip_smoke.burst(cfg.vocab_size, 12)
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0.0]
    tokens = {}
    for _ in range(NCCL_8B_WINDOWS):
        for arm, eng in engines.items():
            window, toks = _burst_window(eng, reqs, LockstepEngine)
            out["windows"][arm].append(window)
            if toks is not None:
                tokens.setdefault(arm, [toks[i] for i in greedy])
    out["greedy"] = tokens or None
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    for eng in engines.values():
        eng.stop()
    return out


def _burst_window(eng, reqs, lockstep_cls) -> tuple:
    """One burst through a LockstepEngine (the leader submits, the others
    replicate), every decode chunk's enqueue between CUDA events: (the
    window's numbers, the leader's tokens per request or None)."""
    import time

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
    t0 = time.monotonic()
    try:
        if lock.is_leader:
            lock.start()
            try:
                hs = [lock.submit(p, sp) for p, sp in reqs]
                toks = [h.collect_tokens(timeout=600)[0] for h in hs]
            finally:
                lock.stop()
        else:
            lock.run_follower()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    finally:
        del eng._run_decode_step
    m = eng.metrics
    steps = m["decode_steps"] - m0["decode_steps"]
    host_s = sum(m[k] - m0[k] for k in ("decode_dispatch_s", "decode_sync_s"))
    chunk_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return dict(decode_steps=steps, early_exit_steps=m["early_exit_steps"] - m0["early_exit_steps"],
                host_ms_per_decode_step=host_s / max(steps, 1) * 1e3, wall_s=wall_s,
                chunk_device_ms=chunk_ms, chunk_device_share=chunk_ms / (wall_s * 1e3)), toks
