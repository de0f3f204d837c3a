"""Rank functions of the port's data- and sequence-parallel tests
(``test_torch_dp.py``, ``test_torch_sp.py``), run by
``parallel.launch.spawn_ranks`` in processes of their own. Imports torch
and the port only: a spawned rank never imports jax."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.collectives import all_gather
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.parallel.ring_attention import ring_attention

GREEDY = dict(temperature=0.0, max_tokens=5)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _counter_clock():
    """A logical clock every rank steps alike (the session LRU's input)."""
    ticks = itertools.count()
    return lambda: float(next(ticks))


def run_turns(eng, turns, sp=GREEDY, on_turn=None) -> list:
    """Each (session_id, new tokens) turn on the session's history (its
    prompts and replies so far); the replies in order."""
    history: dict = {}
    replies = []
    for sid, new in turns:
        prompt = history.get(sid, []) + list(new)
        h = eng.submit(prompt, SamplingParams(**sp), session_id=sid)
        while eng.step():
            pass
        reply = h.collect_tokens(timeout=30)[0]
        history[sid] = prompt + reply
        replies.append(reply)
        if on_turn is not None:
            on_turn(eng, sid)
    return replies


def run_batch(eng, prompts, params) -> list:
    """Sessionless requests submitted together; their tokens in order."""
    hs = [eng.submit(p, SamplingParams(**kw)) for p, kw in zip(prompts, params)]
    while eng.step():
        pass
    return [h.collect_tokens(timeout=30)[0] for h in hs]


# -- test_torch_parallel.py ------------------------------------------------


def mesh_job(rank: int, dims: dict) -> dict:
    """This rank's coordinates on ``make_mesh(**dims)`` and, per axis of
    more than one rank, the job ranks of its line (an all-gather of each
    rank's id over the axis's group) and its index there."""
    mesh = make_mesh(**dims)
    me = torch.tensor([[rank]])
    lines = {axis: (all_gather(me, comm, dim=0).flatten().tolist(), comm.index)
             for axis, comm in mesh.comms.items()}
    return dict(shape=mesh.shape, coords=mesh.coords, lines=lines)


# -- test_torch_dp.py ------------------------------------------------------


def _host(rows) -> np.ndarray:
    """A payload's host rows as numpy (a QuantKV's int8 rows)."""
    return np.asarray(getattr(rows, "q", rows))


def dp_job(rank: int, forward_case: tuple, engine_case: dict, provider: dict) -> dict:
    """dp = 2 x tp = 2 on four ranks: (a) the forward over each shard's
    batch rows, logits and caches gathered whole; (b) per engine config
    the sampled batch and the session script, with where each turn's
    session sat and whether every slot's pages came from its own shard;
    the "prefix" engine then exports session c (on the other shard from
    rank 0's); (c) the sampled batch, the script and the export again on
    a dp = tp = 1 engine of this rank; (d) ``build_engine`` under the env
    contract at dp = 2 x tp = 2 from a checkpoint."""
    from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine

    torch.set_num_threads(1)
    mesh = make_mesh(dp=2, tp=2)
    tp, dp = mesh.comm("tp"), mesh.comm("dp")
    out = {}
    cfg_kw, tree, tokens = forward_case
    cfg = get_config(**cfg_kw)
    params = params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)
    B, T = tokens.shape
    rows = slice(dp.index * B // 2, (dp.index + 1) * B // 2)
    ck, cv = llama.init_kv_cache(cfg, B // 2, 8, "cpu", dtype=torch.float32, tp=2)
    pos = torch.arange(T, dtype=torch.int32).expand(B // 2, T)
    with torch.no_grad():
        lg, ck, cv = llama.forward(params, cfg, torch.from_numpy(tokens[rows]), pos, ck, cv,
                                   torch.zeros(B // 2, dtype=torch.int32), tp)

    def whole(x, tp_dim, dp_dim):
        return _np(all_gather(all_gather(x, tp, dim=tp_dim), dp, dim=dp_dim))

    out["forward"] = dict(logits=whole(lg, -1, 0), k=whole(ck, 3, 1), v=whole(cv, 3, 1))

    cfg = get_config(**engine_case["cfg"])
    batch_prompts, batch_params = engine_case["batch"]
    for name, fields in engine_case["configs"].items():
        eng = InferenceEngine(cfg, EngineConfig(**engine_case["base"], **fields, dp=2, tp=2),
                              params=params_from_jax(engine_case["tree"], "cpu"), seed=0,
                              device="cpu")
        eng.clock = _counter_clock()
        if fields.get("prefix_cache_slots"):
            eng.register_prefix(engine_case["sys"])
        if name == "warm":
            eng.warmup()
        shards, own_pages = [], []

        def note(e, sid):
            shards.append(e._dp.owner(e._sessions[sid].slot))
            a = e._pages
            if a is not None:
                own_pages.append(all(a.page_shard(p) == a.shard_of(i)
                                     for i, pages in enumerate(a.slot_pages) for p in pages))

        res = dict(batch=run_batch(eng, batch_prompts, batch_params),
                   turns=run_turns(eng, engine_case["turns"], on_turn=note),
                   shards=shards, own_pages=own_pages,
                   metrics={k: eng.metrics[k] for k in engine_case["metrics"]},
                   local_slots=int(eng._tokens.shape[0]))
        if fields.get("kv_pages"):
            res["local_pages"] = int(eng._ck.pool.shape[1])
        if name == "prefix":
            # A collective (the tp heads' gather): every rank exports.
            res["export_shard"] = eng._dp.owner(eng._sessions["c"].slot)
            payload = eng.export_session("c")
            res["export"] = (payload.token_ids, _host(payload.host_k), _host(payload.host_v))
        out[name] = res
    one = InferenceEngine(cfg, EngineConfig(**engine_case["base"]),
                          params=params_from_jax(engine_case["tree"], "cpu"), seed=0,
                          device="cpu")
    out["one_batch"] = run_batch(one, batch_prompts, batch_params)
    one = InferenceEngine(cfg, EngineConfig(**engine_case["base"],
                                            **engine_case["configs"]["prefix"]),
                          params=params_from_jax(engine_case["tree"], "cpu"), seed=0,
                          device="cpu")
    one.register_prefix(engine_case["sys"])
    run_batch(one, batch_prompts, batch_params)
    run_turns(one, engine_case["turns"])
    payload = one.export_session("c")
    out["one_export"] = (payload.token_ids, _host(payload.host_k), _host(payload.host_v))

    moe_cfg, moe_tree = engine_case["moe"]
    eng = InferenceEngine(get_config(**moe_cfg), EngineConfig(**engine_case["base"], dp=2, tp=2),
                          params=params_from_jax(moe_tree, "cpu"), seed=0, device="cpu")
    greedy = [(p, kw) for p, kw in zip(batch_prompts, batch_params) if kw["temperature"] == 0.0]
    out["moe"] = run_batch(eng, *zip(*greedy))

    lock = build_engine(ProviderSpec.from_dict(provider["spec"]), device="cpu")
    out["provider_type"] = type(lock).__name__
    out["provider_slots"] = lock.engine._dp.per
    if lock.is_leader:
        lock.start()
        out["provider_tokens"] = lock.generate(provider["prompt"], SamplingParams(
            temperature=0.0, max_tokens=6))[0]
        lock.stop()
    else:
        lock.run_follower()
    return out


# -- test_torch_sp.py ------------------------------------------------------


def sp_job(rank: int, ring_cases: dict, fwd_case: tuple, engine_case: dict) -> dict:
    """On four ranks: (a) ring attention per case over its mesh, each rank
    taking its batch rows (dp) and sequence block (sp), the output
    gathered whole; (b) ``forward_prefill_ring`` at sp = 2 x tp = 2,
    logits and KV rows gathered whole; (c) engines at sp = 2 x tp = 2:
    a long prompt (the ring), a short one (dense), a two-turn session,
    with the ring prefills counted."""
    torch.set_num_threads(1)
    out = {}
    for name, (mesh_kw, q, k, v) in ring_cases.items():
        mesh = make_mesh(**mesh_kw)
        sp, dp = mesh.comm("sp"), mesh.comm("dp")
        B, T = q.shape[:2]
        nb, nt = B // mesh.size("dp"), T // mesh.size("sp")
        b0, t0 = mesh.index("dp") * nb, mesh.index("sp") * nt

        def block(a):
            return torch.from_numpy(a[b0:b0 + nb, t0:t0 + nt])

        o = ring_attention(block(q), block(k), block(v), sp)
        out[name] = _np(all_gather(all_gather(o, sp, dim=1), dp, dim=0))

    mesh = make_mesh(sp=2, tp=2)
    tp, sp = mesh.comm("tp"), mesh.comm("sp")
    cfg_kw, tree, tokens = fwd_case
    cfg = get_config(**cfg_kw)
    params = params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32).expand(tokens.shape)
    with torch.no_grad():
        lg, kc, vc = llama.forward_prefill_ring(params, cfg, torch.from_numpy(tokens), pos,
                                                tp, sp)
    out["forward"] = dict(
        logits=_np(all_gather(llama.gather_logits(lg, tp), sp, dim=1)),
        k=_np(all_gather(all_gather(kc, tp, dim=3), sp, dim=2)),
        v=_np(all_gather(all_gather(vc, tp, dim=3), sp, dim=2)))

    cfg = get_config(**engine_case["cfg"])

    def engine(**fields):
        ecfg = EngineConfig(**{**engine_case["base"], "tp": 2, "sp": 2, **fields})
        eng = InferenceEngine(cfg, ecfg, params=params_from_jax(engine_case["tree"], "cpu"),
                              seed=0, device="cpu")
        ring = eng._prefill_ring_fn
        calls = []

        def counted(*a):
            calls.append(1)
            return ring(*a)

        eng._prefill_ring_fn = counted
        return eng, calls

    eng, calls = engine()
    sp_greedy = SamplingParams(**GREEDY)
    out["long"] = eng.generate(engine_case["long"], sp_greedy)[0]
    out["ring_after_long"] = len(calls)
    out["short"] = eng.generate(engine_case["short"], sp_greedy)[0]
    out["ring_after_short"] = len(calls)
    eng, calls = engine()
    eng.warmup()
    out["warm_tasks"] = [f"{f}:{k}" for f, k, _fn in eng._warmup_tasks()]
    calls.clear()
    out["session"] = run_turns(eng, [("lc-1", engine_case["session"]), ("lc-1", [7])])
    out["session_ring"] = len(calls)
    out["reuse"] = eng.metrics["prefix_reuse_tokens"]
    out["sp_ops"] = sorted(eng._sp.op_stats)
    eng, calls = engine(**engine_case["k4"])
    out["k4_long"] = eng.generate(engine_case["long"], sp_greedy)[0]
    out["k4_ring"] = len(calls)
    # dp = 2 x sp = 2: each shard's sp ring prefills the prompt its slot got.
    eng, calls = engine(dp=2, tp=1)
    out["dp_sp"] = run_batch(eng, [engine_case["long"], engine_case["session"]],
                             [GREEDY, GREEDY])
    out["dp_sp_ring"] = len(calls)
    return out


# -- test_torch_nccl_cuda.py -----------------------------------------------

NCCL_MESH_ENGINE = dict(num_slots=2, max_seq=128, prefill_buckets=(16, 32), decode_chunk=4,
                        dtype="float32", max_sessions=0, long_prefill_threshold=32)


def nccl_mesh_job(rank: int, dims: dict) -> dict:
    """The NCCL route of dp or sp with tp, one rank per card: the ring
    shift's values (sp) or the dp token gather's (dp) on the rank's card,
    then test-tiny-gqa8's greedy tokens through ``LockstepEngine`` on the
    K1 and K4 caches (the 20-token prompt's bucket takes the ring under
    sp); rank 0 also serves the prompts on a tp = 1 engine."""
    from omnia_tpu_torch.engine.multihost import LockstepEngine
    from omnia_tpu_torch.parallel.distributed import rank_device
    from torch_tp_workers import NCCL_CACHES, NCCL_PROMPTS, _greedy, nccl_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(**dims)
    dev = rank_device()
    axis = "sp" if dims.get("sp", 1) > 1 else "dp"
    comm = mesh.comm(axis)
    out = dict(backend=comm.backend, device=str(dev), index=comm.index)
    x = torch.from_numpy(nccl_rows(rank)).to(dev)
    if axis == "sp":
        out["shift"] = _np(comm.shift(x))
        out["shift_bf16"] = _np(comm.shift(x.bfloat16()).float())
    else:
        toks = torch.arange(8, dtype=torch.int32, device=dev).reshape(4, 2) + 100 * rank
        out["gather"] = _np(comm.all_gather(toks, dim=1))
    cfg = get_config("test-tiny-gqa8")
    for label, fields in NCCL_CACHES.items():
        eng = InferenceEngine(cfg, EngineConfig(**NCCL_MESH_ENGINE, **fields, **dims), seed=3)
        rings = []
        if eng._prefill_ring_fn is not None:
            ring = eng._prefill_ring_fn

            def counted(*a, ring=ring):
                rings.append(1)
                return ring(*a)

            eng._prefill_ring_fn = counted
        lock = LockstepEngine(eng)
        lock.warmup()
        rings.clear()
        if lock.is_leader:
            lock.start()
            sp = SamplingParams(temperature=0.0, max_tokens=12)
            hs = [lock.submit(p, sp) for p in NCCL_PROMPTS]
            out[label] = [h.collect_tokens(timeout=120)[0] for h in hs]
            lock.stop()
            ref = InferenceEngine(cfg, EngineConfig(**NCCL_MESH_ENGINE, **fields), seed=3)
            out[f"{label}_tp1"] = _greedy(ref, NCCL_PROMPTS, 12)
        else:
            lock.run_follower()
        out[f"{label}_rings"] = len(rings)
        out[f"{label}_engine_device"] = str(eng.device)
    return out
