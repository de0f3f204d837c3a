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
# llama3-8b at tp = 2: the burst's windows, ring on and off in turns.
NCCL_8B_SEED, NCCL_8B_WINDOWS = 27, 3
# The whole Mixtral-8x7B at tp = 4 (two experts and two KV heads a rank):
# (1) cut to 2 layers, f32, against one rank: a prefill of 8 rows x 8
# tokens (64 rows: the capacity dispatch) then one decode step of 8 rows
# (the all-expert path, on K1), and greedy requests whose prefill buckets
# hold 64-256 rows; (2) all 32 layers in bf16, the burst's windows, ring
# on and off in turns.
NCCL_MIXTRAL_TP, NCCL_MIXTRAL_SEED, NCCL_MIXTRAL_WINDOWS = 4, 31, 3
NCCL_MIXTRAL_CHECK_LAYERS, NCCL_MIXTRAL_LOGITS_TOL = 2, 1e-3
NCCL_MIXTRAL_CHECK_ENGINE = dict(num_slots=8, max_seq=256, prefill_buckets=(32, 64, 128, 256),
                                 dtype="float32", max_sessions=0)
NCCL_MIXTRAL_PROMPT_LENGTHS, NCCL_MIXTRAL_NEW_TOKENS = (17, 64, 100, 200), 12


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
               kv_bytes=engines["on"].metrics["kv_quant_device_bytes"],
               layers=cfg.num_layers, edition=engines["on"]._kernel_edition())
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


def _mixtral_forward(params, cfg, tokens: np.ndarray, dev, tp) -> np.ndarray:
    """A prefill of tokens[:, :-1] ([8, 8]: 64 rows, the capacity
    dispatch) into a fresh cache, then one decode step of tokens[:, -1:]
    (8 rows, the all-expert path; on the card K1): the prefill's last
    row's and the step's logits [8, 2, V], gathered over tp."""
    B, T = tokens.shape[0], tokens.shape[1] - 1
    ck, cv = llama.init_kv_cache(cfg, B, 2 * T, dev, dtype=torch.float32,
                                 tp=1 if tp is None else tp.size)
    tok = torch.from_numpy(tokens).to(dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    with torch.no_grad():
        lg, _, _ = llama.forward(params, cfg, tok[:, :T], pos, ck, cv,
                                 torch.zeros(B, dtype=torch.int32, device=dev), tp)
        step = torch.full((B, 1), T, dtype=torch.int32, device=dev)
        lg1, _, _ = llama.forward(params, cfg, tok[:, T:], step, ck, cv, step[:, 0], tp)
        return _np(llama.gather_logits(torch.cat([lg[:, -1:], lg1], dim=1), tp))


def _lockstep_rows(eng, reqs, lockstep_cls):
    """The requests through a warmed LockstepEngine: the leader's tokens
    per request, None on the others."""
    lock = lockstep_cls(eng)
    lock.warmup()
    if not lock.is_leader:
        lock.run_follower()
        return None
    lock.start()
    try:
        hs = [lock.submit(p, sp) for p, sp in reqs]
        return [h.collect_tokens(timeout=600)[0] for h in hs]
    finally:
        lock.stop()


def _mixtral_check(rank: int, dev, mesh) -> dict:
    """(1): Mixtral's full width cut to NCCL_MIXTRAL_CHECK_LAYERS layers,
    f32, TF32 off, drawn whole from one seed and cut on every rank; rank 0
    also holds the whole tree. The tp = 4 forward's logits and a tp = 4
    engine's greedy tokens (K1), and on rank 0 the one-rank ones."""
    from omnia_tpu_torch.engine.multihost import LockstepEngine

    cfg = get_config("mixtral-8x7b", num_layers=NCCL_MIXTRAL_CHECK_LAYERS)
    rng = np.random.default_rng(NCCL_MIXTRAL_SEED)
    tokens = rng.integers(0, cfg.vocab_size, (8, 9)).astype(np.int64)
    reqs = [([int(t) for t in rng.integers(0, cfg.vocab_size, n)],
             SamplingParams(temperature=0.0, max_tokens=NCCL_MIXTRAL_NEW_TOKENS))
            for n in NCCL_MIXTRAL_PROMPT_LENGTHS]

    def draw(mesh):
        return llama.init_params(cfg, torch.Generator(device=dev).manual_seed(NCCL_MIXTRAL_SEED),
                                 dev, dtype=torch.float32, mesh=mesh)

    params = draw(mesh)
    out = dict(logits=_mixtral_forward(params, cfg, tokens, dev, mesh.comm("tp")),
               experts=int(params["layers"]["mlp"]["wg"].shape[1]))
    eng = InferenceEngine(cfg, EngineConfig(**NCCL_MIXTRAL_CHECK_ENGINE, tp=NCCL_MIXTRAL_TP),
                          params=params, device=dev)
    out["greedy"] = _lockstep_rows(eng, reqs, LockstepEngine)
    out["edition"] = eng._kernel_edition()
    eng.stop()
    del eng, params
    if rank == 0:
        whole = draw(None)
        out["logits_tp1"] = _mixtral_forward(whole, cfg, tokens, dev, None)
        ref = InferenceEngine(cfg, EngineConfig(**NCCL_MIXTRAL_CHECK_ENGINE), params=whole,
                              device=dev)
        hs = [ref.submit(p, sp) for p, sp in reqs]
        _drain(ref)
        out["greedy_tp1"] = [h.collect_tokens(timeout=600)[0] for h in hs]
        ref.stop()
        del ref, whole
    return out


def nccl_mixtral_job(rank: int) -> dict:
    """The whole Mixtral-8x7B at tp = 4 over NCCL, one rank per card, on
    random seeded weights. (1) ``_mixtral_check``; (2) all 32 layers in
    bf16, each leaf drawn whole and cut (``init_params(mesh=)``): a decode
    ring engine and a ring-off one over the same weights, each warmed
    through LockstepEngine, serve chip_smoke.py's 12-request burst in
    alternating windows, as ``nccl_8b_job``'s, with the decode-attention
    launches counted on the card per window. Each rank's params and KV
    bytes, init / warmup / capture seconds, pool bytes, one captured
    step's collectives and (2)'s peak memory."""
    import gc
    import time

    import chip_smoke
    from omnia_tpu_torch.engine.multihost import LockstepEngine
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    mesh = make_mesh(tp=NCCL_MIXTRAL_TP)
    out = dict(rank=rank, check=_mixtral_check(rank, dev, mesh), windows={"on": [], "off": []})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mixtral-8x7b")
    t0 = time.monotonic()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(NCCL_MIXTRAL_SEED),
                               dev, dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    out.update(init_s=time.monotonic() - t0, init_peak_bytes=torch.cuda.max_memory_allocated())
    engines = {}
    for arm, ring in (("on", 2), ("off", 0)):
        eng = InferenceEngine(cfg, EngineConfig(tp=NCCL_MIXTRAL_TP, decode_ring=ring),
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
               layers=cfg.num_layers, edition=engines["on"]._kernel_edition())
    reqs = chip_smoke.burst(cfg.vocab_size, 12)
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0.0]
    tokens = {}
    for _ in range(NCCL_MIXTRAL_WINDOWS):
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
    replicate), every decode chunk's enqueue between CUDA events, the
    decode-attention launches counted on the card (set to 0 just before,
    read just after) beside the steps that ran: (the window's numbers,
    the leader's tokens per request or None)."""
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
    launches = da.launches()
    m = eng.metrics
    steps = m["decode_steps"] - m0["decode_steps"]
    early = m["early_exit_steps"] - m0["early_exit_steps"]
    host_s = sum(m[k] - m0[k] for k in ("decode_dispatch_s", "decode_sync_s"))
    chunk_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return dict(decode_steps=steps, early_exit_steps=early, ran=steps - early,
                launches=launches, host_ms_per_decode_step=host_s / max(steps, 1) * 1e3,
                wall_s=wall_s, chunk_device_ms=chunk_ms,
                chunk_device_share=chunk_ms / (wall_s * 1e3)), toks
