"""Rank functions of the port's tensor-parallel tests (``test_torch_tp.py``,
``test_torch_multihost.py``), run by ``parallel.launch.spawn_ranks`` in
processes of their own. Imports torch and the port only: a spawned rank
never imports jax."""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.multihost import LockstepEngine
from omnia_tpu_torch.models import get_config, llama, quant
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.parallel.sharding import gather_pytree, shard_pytree


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _greedy(engine, prompts, max_tokens) -> list:
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
    handles = [engine.submit(p, sp) for p in prompts]
    while engine.step():
        pass
    return [h.collect_tokens(timeout=30)[0] for h in handles]


# -- test_torch_tp.py ------------------------------------------------------


def tp2_job(rank: int, cases: dict, ckpts: dict, provider: tuple) -> dict:
    """The tp=2 checks: the forwards (``forward_job``); each checkpoint
    loaded with the mesh equal to this rank's slice of the whole load
    (full precision and both int8 modes); and ``build_engine`` under the
    env contract giving a LockstepEngine whose leader serves a prompt."""
    from omnia_tpu_torch.models import checkpoint as ckpt_io
    from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine

    out = forward_job(rank, cases)
    mesh = make_mesh(tp=torch.distributed.get_world_size())
    out["halves"] = half_collectives_job(rank, mesh.comm("tp"))
    loads = {}
    for name, path in ckpts.items():
        cfg = ckpt_io.read_config(path)
        for q in (None,) if cfg.is_moe else (None, "int8", "int8-dynamic"):
            specs = llama.param_specs(cfg)
            if q:
                specs = quant.quantize_param_specs(specs, cfg, q)
            whole = ckpt_io.load_params(path, cfg, dtype=torch.float32, device="cpu", quant=q)
            want = shard_pytree(whole, specs, mesh)
            got = ckpt_io.load_params(path, cfg, dtype=torch.float32, device="cpu", quant=q,
                                      mesh=mesh)
            loads[f"{name}/{q}"] = all(
                a.shape == b.shape and a.stride() == b.stride() and torch.equal(a, b)
                for a, b in zip(_leaves(got), _leaves(want)))
    out["loads"] = loads
    spec, prompt = provider
    lock = build_engine(ProviderSpec.from_dict(spec), device="cpu")
    out["provider_type"] = type(lock).__name__
    if lock.is_leader:
        lock.start()
        out["provider_tokens"] = lock.generate(prompt, SamplingParams(temperature=0.0,
                                                                      max_tokens=8))[0]
        lock.stop()
    else:
        lock.run_follower()
    out["provider_local_wq"] = lock.engine.params["layers"]["attn"]["wq"].shape[-1]
    return out


def forward_job(rank: int, cases: dict) -> dict:
    """The tp=2 forwards: per case, prefill then one decode step over a
    cache at this rank's KV heads; logits and caches gathered to whole.
    Also the shard -> gather round trip of the case's params."""
    torch.set_num_threads(1)
    mesh = make_mesh(tp=torch.distributed.get_world_size())
    tp = mesh.comm("tp")
    out = {}
    for name, (cfg_kw, tree, tokens, nxt) in cases.items():
        cfg = get_config(**cfg_kw)
        params = params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)
        whole = params_from_jax(tree, "cpu")
        back = gather_pytree(params, llama.param_specs(cfg), mesh)
        same = all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(whole)))
        B, T = tokens.shape
        ck, cv = llama.init_kv_cache(cfg, B, 8, "cpu", dtype=torch.float32, tp=tp.size)
        pos = torch.arange(T, dtype=torch.int32).expand(B, T)
        with torch.no_grad():
            lg, ck, cv = llama.forward(params, cfg, torch.from_numpy(tokens), pos, ck, cv,
                                       torch.zeros(B, dtype=torch.int32), tp)
            lg1, ck, cv = llama.forward(params, cfg, torch.from_numpy(nxt),
                                        torch.full((B, 1), T, dtype=torch.int32), ck, cv,
                                        torch.full((B,), T, dtype=torch.int32), tp)
        kspec, vspec = llama.kv_cache_specs()
        out[name] = dict(
            prefill=_np(llama.gather_logits(lg, tp)), decode=_np(llama.gather_logits(lg1, tp)),
            k=_np(gather_pytree(ck, kspec, mesh)), v=_np(gather_pytree(cv, vspec, mesh)),
            local_heads=ck.shape[3], round_trip=same)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def tp4_job(rank: int, moe: tuple, q: tuple, engine_fields: dict, prompts: list) -> dict:
    """The tp=4 checks: (a) test-tiny-moe forward_train at 8 rows (all
    experts) and 80 (capacity dispatch); (b) per int8 mode the forward's
    logits and an engine's greedy tokens on test-tiny-gqa8, each rank
    stepping the same requests."""
    torch.set_num_threads(1)
    mesh = make_mesh(tp=torch.distributed.get_world_size())
    tp = mesh.comm("tp")
    out = {}
    cfg_kw, tree, token_sets = moe
    cfg = get_config(**cfg_kw)
    params = params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)
    with torch.no_grad():
        out["moe"] = [_np(llama.forward_train(params, cfg, torch.from_numpy(t), tp))
                      for t in token_sets]
    cfg_kw, tree, tokens = q
    cfg = get_config(**cfg_kw)
    for mode in ("int8", "int8-dynamic"):
        whole = quant.quantize_params(params_from_jax(tree, "cpu"), cfg, mode)
        specs = quant.quantize_param_specs(llama.param_specs(cfg), cfg, mode)
        local = shard_pytree(whole, specs, mesh)
        with torch.no_grad():
            lg, _, _ = llama.forward_prefill(local, cfg, torch.from_numpy(tokens),
                                             torch.arange(tokens.shape[1]).expand(tokens.shape),
                                             tp)
        eng = InferenceEngine(cfg, EngineConfig(**engine_fields, quant=mode, tp=mesh.size("tp")),
                              params=params_from_jax(tree, "cpu"), device="cpu")
        out[mode] = dict(logits=_np(llama.gather_logits(lg, tp)),
                         tokens=_greedy(eng, prompts, 8),
                         wq_cols=eng.params["layers"]["attn"]["wq"]["s"].shape[-1])
    return out


def half_rows(rank: int) -> np.ndarray:
    return np.random.default_rng(rank).standard_normal((3, 5), np.float32)


def half_collectives_job(rank: int, tp) -> dict:
    """bf16 and fp16 through the collectives (a gathered session payload
    in bf16 takes the gather): gathers on the last and the first dim, and
    a sum."""
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        x = torch.from_numpy(half_rows(rank)).to(dt)
        out[str(dt)] = dict(last=_np(all_gather(x, tp, -1).float()),
                            first=_np(all_gather(x, tp, 0).float()),
                            sum=_np(all_reduce_sum(x, tp).float()))
    return out


# -- test_torch_multihost.py -----------------------------------------------


def run_script(turn, script: dict) -> dict:
    """The multihost script over ``turn(prompt, session_id) -> tokens``:
    every session turn's prompt is the session's history (prompts and
    replies) and its new tokens, so a script gives the same prompts on
    any engine that gives the same replies."""
    history: dict = {}
    out = []
    for sid, new in script["turns"]:
        prompt = history.get(sid, []) + list(new)
        reply = turn(prompt, sid)
        history[sid] = prompt + reply
        out.append(reply)
    return dict(sessions=out, history=history)


def lockstep_job(rank: int, cfg_kw: dict, tree: dict, base: dict, caches: dict,
                 script: dict, imported) -> dict:
    """Per KV cache, a tp engine under LockstepEngine: rank 0 serves a
    greedy burst and the session script through submit(), the others
    replicate. On the contiguous cache a session exported by a tp = 1
    engine is imported first and continued after the script, and one
    session is exported after the stop (a gather over every rank)."""
    torch.set_num_threads(1)
    world = torch.distributed.get_world_size()
    cfg = get_config(**cfg_kw)
    out = {}
    for name, fields in caches.items():
        eng = InferenceEngine(cfg, EngineConfig(**base, **fields, tp=world),
                              params=params_from_jax(tree, "cpu"), device="cpu")
        carry = name == "contiguous" and imported is not None
        if carry:
            eng.import_session(imported[0])
        lock = LockstepEngine(eng)
        lock.warmup()
        res = {}
        if lock.is_leader:
            lock.start()

            def turn(prompt, sid):
                sp = SamplingParams(temperature=0.0, max_tokens=script["turn_tokens"])
                return lock.submit(prompt, sp, session_id=sid).collect_tokens(timeout=120)[0]

            sp = SamplingParams(temperature=0.0, max_tokens=script["burst_tokens"])
            hs = [lock.submit(p, sp) for p in script["burst"]]
            res["burst"] = [h.collect_tokens(timeout=120)[0] for h in hs]
            res.update(run_script(turn, script))
            if carry:
                sid, prompt = imported[1]
                res["imported"] = turn(prompt, sid)
            # The stop's tick carries the release: every rank applies it.
            lock.release_session(script["released"])
            lock.stop()
        else:
            lock.run_follower()
        res["metrics"] = {k: eng.metrics[k] for k in (
            "tokens_generated", "session_offloads", "session_restores", "prefix_reuse_tokens")}
        res["sessions_left"] = sorted(eng._sessions)
        cache = eng._ck.pool if hasattr(eng._ck, "pool") else eng._ck
        res["local_kv_heads"] = getattr(cache, "q", cache).shape[3]
        if name == "contiguous":
            res["export"] = eng.export_session(script["exported"])
        out[name] = res
    return out


def death_job(rank: int, cfg_kw: dict, marker: str, tick_timeout_s: float) -> dict:
    """The follower dies mid-turn (no shutdown handshake); the leader's
    live handle must end ERROR, health must flip and a new submit fail
    fast, all within the tick bound."""
    torch.set_num_threads(1)
    cfg = get_config(**cfg_kw)
    eng = InferenceEngine(cfg, EngineConfig(num_slots=2, max_seq=128, prefill_buckets=(8,),
                                            dtype="float32", tp=2, decode_chunk=2,
                                            max_sessions=0),
                          seed=3, device="cpu")
    lock = LockstepEngine(eng, tick_timeout_s=tick_timeout_s)
    lock.warmup()
    if not lock.is_leader:
        def die_on_marker():
            while not os.path.exists(marker):
                time.sleep(0.05)
            os._exit(9)

        threading.Thread(target=die_on_marker, daemon=True).start()
        lock.run_follower()
        return {}
    lock.start()
    h = lock.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=120))
    t0 = time.monotonic()
    final, tokens = None, 0
    for ev in h.events(timeout=120):
        if ev.token_id is not None:
            tokens += 1
            if tokens == 1:
                open(marker, "w").write("turn-started")
        if ev.is_final:
            final = ev
            break
    elapsed = time.monotonic() - t0
    deadline = time.monotonic() + 30
    while lock.healthy() and time.monotonic() < deadline:
        time.sleep(0.2)
    healthy = lock.healthy()
    t1 = time.monotonic()
    _, fin2 = lock.submit([4, 5], SamplingParams(max_tokens=4)).collect_tokens(timeout=15)
    return dict(final=final.finish_reason.value, error=final.error, tokens=tokens,
                elapsed=elapsed, healthy=healthy, second=fin2.finish_reason.value,
                second_s=time.monotonic() - t1)


def warmup_mismatch_job(rank: int, case: str, rank_timeout_s: float) -> dict:
    """Warmup's collectives need every rank on the same task list: with
    ``case`` "config" rank 1 builds other prefill buckets (every rank must
    raise at once, naming the mismatch); with "absent" rank 1 never warms
    up (rank 0 must raise within the group's timeout, not hang)."""
    torch.set_num_threads(1)
    buckets = (8, 16) if rank == 1 and case == "config" else (8,)
    eng = InferenceEngine(get_config("test-tiny"),
                          EngineConfig(num_slots=2, max_seq=64, prefill_buckets=buckets,
                                       dtype="float32", tp=2, max_sessions=0),
                          seed=3, device="cpu")
    if case == "absent" and rank == 1:
        time.sleep(rank_timeout_s + 3)
        return {}
    t0 = time.monotonic()
    try:
        eng.warmup()
    except RuntimeError as e:
        return dict(error=str(e), seconds=time.monotonic() - t0)
    return dict(error=None, seconds=time.monotonic() - t0)


# -- test_torch_nccl_cuda.py -----------------------------------------------

NCCL_ENGINE = dict(num_slots=2, max_seq=128, prefill_buckets=(16, 32), decode_chunk=4,
                   dtype="float32", max_sessions=0)
NCCL_CACHES = {"K1": dict(), "K4": dict(kv_quant="int8", kv_pages=12, kv_page_tokens=16)}
NCCL_PROMPTS = [[3, 14, 15, 92, 65], list(range(7, 27)), [2, 71, 82, 81, 82, 84, 59, 4]]


def nccl_rows(rank: int) -> np.ndarray:
    return np.random.default_rng(rank).standard_normal((3, 40), np.float32)


def nccl_job(rank: int) -> dict:
    """The NCCL route, one rank per card: each collective of ``Comm`` on
    the rank's card (a bf16 and an f32 sum and max, a bf16 gather, a
    byte broadcast), then test-tiny-gqa8's greedy tokens at tp = world
    through ``LockstepEngine`` on the K1 and K4 caches; rank 0 also
    serves the prompts on a tp = 1 engine of the same seed."""
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.distributed.get_world_size()
    tp = make_mesh(tp=world).comm("tp")
    dev = rank_device()
    out = dict(backend=tp.backend, device=str(dev), current=torch.cuda.current_device())
    x = torch.from_numpy(nccl_rows(rank))
    for dt in (torch.float32, torch.bfloat16):
        mine = x.to(dev, dt)
        out[f"sum_{dt}"] = _np(tp.all_reduce(mine, torch.distributed.ReduceOp.SUM).float())
        out[f"max_{dt}"] = _np(tp.all_reduce(mine, torch.distributed.ReduceOp.MAX).float())
    out["gather"] = _np(tp.all_gather(x.to(dev, torch.bfloat16), -1).float())
    out["broadcast"] = _np(tp.broadcast(torch.arange(5, dtype=torch.uint8, device=dev) + rank))
    cfg = get_config("test-tiny-gqa8")
    for label, fields in NCCL_CACHES.items():
        eng = InferenceEngine(cfg, EngineConfig(**NCCL_ENGINE, **fields, tp=world), seed=3)
        lock = LockstepEngine(eng)
        lock.warmup()
        if lock.is_leader:
            lock.start()
            sp = SamplingParams(temperature=0.0, max_tokens=12)
            hs = [lock.submit(p, sp) for p in NCCL_PROMPTS]
            out[label] = [h.collect_tokens(timeout=120)[0] for h in hs]
            lock.stop()
            ref = InferenceEngine(cfg, EngineConfig(**NCCL_ENGINE, **fields), seed=3)
            out[f"{label}_tp1"] = _greedy(ref, NCCL_PROMPTS, 12)
        else:
            lock.run_follower()
        out[f"{label}_engine_device"] = str(eng.device)
    return out
