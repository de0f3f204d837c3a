"""Lockstep serving in the port (``engine/multihost.py``) against the JAX
engine, on the CPU over a gloo group of spawned ranks: the analogs of
``tests/test_distributed.py::test_lockstep_engine_two_processes``,
``::test_lockstep_engine_four_processes`` and
``::test_lockstep_follower_death_bounded``.

At tp = 2 and tp = 4 on test-tiny-gqa8 (8 KV heads), f32, for the
contiguous, int8, paged and int8 + paged caches, rank 0 serves a greedy
burst and a session script (3 sessions of 2 turns on 2 slots: offloads
and restores) through ``LockstepEngine.submit()`` while the others
replicate: the tokens equal the JAX engine's on the same weights and
caches, and every rank's books agree. A session exported by a tp = 1
port engine imports at tp and continues with JAX's tokens; one exported
at tp (a gather of every rank's heads) imports at tp = 1 and continues
with JAX's tokens. A follower killed mid-turn ends the leader's turn in
ERROR within the tick bound. Warmup raises, never hangs, when the
ranks' task lists differ or a rank never arrives."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_tp_workers as workers
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel import launch

CFG = dict(name="test-tiny-gqa8")
BASE = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
            dtype="float32", max_sessions=4)
CACHES = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=12, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=12, kv_page_tokens=16),
}
_rng = np.random.default_rng(7)


def _toks(n):
    return [int(t) for t in _rng.integers(1, 256, size=n)]


SCRIPT = dict(
    burst=[_toks(n) for n in (3, 12, 20, 9)], burst_tokens=6, turn_tokens=4,
    turns=[("s0", _toks(5)), ("s1", _toks(9)), ("s2", _toks(4)),
           ("s0", _toks(6)), ("s1", _toks(3)), ("s2", _toks(7))],
    released="s1", exported="s0")
CARRIED = ("x", _toks(6), _toks(5))      # the tp = 1 session: two turns' new tokens
CONTINUE = _toks(4)                       # the new tokens of a carried session's next turn


def _jax_turn(eng):
    def turn(prompt, sid):
        h = eng.submit(prompt, JSamplingParams(temperature=0.0, max_tokens=SCRIPT["turn_tokens"]),
                       session_id=sid)
        while eng.step():
            pass
        return h.collect_tokens(timeout=30)[0]
    return turn


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return {"OMNIA_WARMUP_MANIFEST_DIR": str(tmp_path_factory.mktemp("manifests"))}


@pytest.fixture(scope="module")
def setup(env):
    """JAX's tokens per cache, and the tp = 1 port session to carry."""
    jparams = jllama.init_params(jget_config(**CFG), jax.random.key(11), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    ref = {}
    for name, fields in CACHES.items():
        eng = JEngine(jget_config(**CFG), JEngineConfig(**BASE, **fields), params=jparams)
        sp = JSamplingParams(temperature=0.0, max_tokens=SCRIPT["burst_tokens"])
        hs = [eng.submit(p, sp) for p in SCRIPT["burst"]]
        while eng.step():
            pass
        out = dict(burst=[h.collect_tokens(timeout=30)[0] for h in hs])
        out.update(workers.run_script(_jax_turn(eng), SCRIPT))
        if name == "contiguous":
            sid, a, b = CARRIED
            carried = workers.run_script(_jax_turn(eng), dict(turns=[(sid, a), (sid, b),
                                                                     (sid, CONTINUE)]))
            out["imported"] = carried["sessions"][-1]
            turn = _jax_turn(eng)
            out["exported_next"] = turn(out["history"]["s0"] + CONTINUE, "s0")
        ref[name] = out

    # The carried session's first two turns on a tp = 1 port engine.
    one = InferenceEngine(get_config(**CFG), EngineConfig(**BASE), params=params_from_jax(tree, "cpu"),
                          device="cpu")

    def turn(prompt, sid):
        h = one.submit(prompt, SamplingParams(temperature=0.0, max_tokens=SCRIPT["turn_tokens"]),
                       session_id=sid)
        while one.step():
            pass
        return h.collect_tokens(timeout=30)[0]

    sid, a, b = CARRIED
    hist = workers.run_script(turn, dict(turns=[(sid, a), (sid, b)]))["history"][sid]
    imported = (one.export_session(sid), (sid, hist + CONTINUE))
    return tree, ref, imported


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def lockstep(request, setup, env):
    tree, ref, imported = setup
    got = launch.spawn_ranks(workers.lockstep_job, request.param,
                             args=(CFG, tree, BASE, CACHES, SCRIPT, imported),
                             backend="gloo", env=env, timeout_s=300)
    return request.param, tree, ref, got


@pytest.mark.parametrize("cache", list(CACHES))
def test_leader_tokens_match_jax(lockstep, cache):
    tp, _, ref, got = lockstep
    leader = got[0][cache]
    assert leader["burst"] == ref[cache]["burst"]
    assert leader["sessions"] == ref[cache]["sessions"]
    assert leader["local_kv_heads"] == 8 // tp
    m = leader["metrics"]
    assert m["session_offloads"] > 0 and m["session_restores"] > 0
    assert m["prefix_reuse_tokens"] > 0
    for follower in got[1:]:
        # Identical books on every rank: the step streams stayed in lockstep.
        assert follower[cache]["metrics"] == m
        assert follower[cache]["sessions_left"] == leader["sessions_left"]
    assert "s1" not in leader["sessions_left"]   # the release replicated


def test_sessions_cross_between_tp_degrees(lockstep, setup):
    """tp = 1 → tp: the carried session continues with JAX's tokens;
    tp → tp = 1: the exported payload holds every head and continues with
    JAX's tokens on a tp = 1 engine."""
    tp, tree, ref, got = lockstep
    leader = got[0]["contiguous"]
    assert leader["imported"] == ref["contiguous"]["imported"]
    pay = leader["export"]
    assert pay.host_k.shape[2] == 8
    for follower in got[1:]:
        assert np.array_equal(follower["contiguous"]["export"].host_k, pay.host_k)
    one = InferenceEngine(get_config(**CFG), EngineConfig(**BASE),
                          params=params_from_jax(tree, "cpu"), device="cpu")
    one.import_session(pay)
    prompt = ref["contiguous"]["history"]["s0"] + CONTINUE
    h = one.submit(prompt, SamplingParams(temperature=0.0, max_tokens=SCRIPT["turn_tokens"]),
                   session_id="s0")
    while one.step():
        pass
    assert h.collect_tokens(timeout=30)[0] == ref["contiguous"]["exported_next"]
    assert one.metrics["session_restores"] == 1


def test_follower_death_is_bounded(env, tmp_path):
    """The follower exits mid-turn with no handshake: the leader's turn
    ends ERROR within the tick bound, health flips, and a new submit
    fails fast."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = launch.free_port()
    marker = str(tmp_path / "turn-started")
    args = (dict(name="test-tiny", num_heads=2, num_kv_heads=2), marker, 3.0)
    procs = [ctx.Process(target=launch._rank_main,
                         args=(r, 2, port, "gloo", 600.0, env, workers.death_job, args, out),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        rank, ok, res = out.get(timeout=180)
        procs[1].join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert (rank, ok) == (0, True), res
    assert procs[1].exitcode == 9                    # the follower really died mid-turn
    assert res["final"] == "error" and res["tokens"] >= 1, res
    assert res["elapsed"] < 30, res
    assert res["healthy"] is False
    assert res["second"] == "error" and res["second_s"] < 5, res


@pytest.mark.parametrize("case", ["config", "absent"])
def test_warmup_mismatch_raises_within_a_bound(env, case):
    """A rank whose warmup task list differs makes every rank raise at the
    agreement check; a rank that never warms up makes the others raise
    after the process group's timeout (3 s here) instead of hanging."""
    got = launch.spawn_ranks(workers.warmup_mismatch_job, 2, args=(case, 3.0), backend="gloo",
                             env=env, timeout_s=120, rank_timeout_s=3.0)
    if case == "config":
        for r in got:
            assert "warmup task lists differ across tp ranks" in r["error"]
    else:
        assert got[0]["error"] is not None and got[0]["seconds"] < 15, got[0]
