"""Sessionful serving in the port held against the JAX engine on the CPU:
multi-turn KV reuse, chunked extend, host paging, the session cap, and
session export / import, with the contiguous, int8, paged and int8 +
paged KV caches. The same converted ``test-tiny`` f32 params, the same
EngineConfig field values and the same greedy script give identical
tokens, finish reasons and session metrics; a reused turn gives a fresh
engine's tokens; payloads move between the two packages."""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.coordinator import EngineCoordinator
from omnia_tpu.engine.types import SessionExport as JSessionExport
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import kv_quant as jkvq
from omnia_tpu.models import llama as jllama
from omnia_tpu.models import paged_kv as jpkv
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.types import SessionExport
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import kv_quant as tkvq
from omnia_tpu_torch.models import paged_kv as tpkv
from omnia_tpu_torch.models.convert import params_from_jax

# 4 slots of 96 rows; 12 sessions at most; 25 pages of 16 rows hold every
# slot's full rows, so no placement of the script needs a reclaim.
ENGINE_FIELDS = dict(num_slots=4, max_seq=96, prefill_buckets=(8, 16, 32),
                     decode_chunk=4, dtype="float32", max_sessions=12)
KV_CONFIGS = {
    "contiguous": dict(),
    "int8": dict(kv_quant="int8"),
    "paged": dict(kv_pages=25, kv_page_tokens=16),
    "int8_paged": dict(kv_quant="int8", kv_pages=25, kv_page_tokens=16),
}
MAX_TOKENS = 4
METRICS = ("prefill_tokens", "prefix_reuse_tokens", "extend_steps",
           "session_offloads", "session_restores")


def _turn(engine, prompt, sid, sp_cls):
    """One greedy request stepped inline → (tokens, finish, metric deltas)."""
    before = {k: engine.metrics[k] for k in METRICS}
    h = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=MAX_TOKENS), session_id=sid)
    while engine.step():
        pass
    toks, fin = h.collect_tokens(timeout=5)
    return toks, fin.finish_reason.value, {k: engine.metrics[k] - before[k] for k in METRICS}


def _script(engine, sp_cls):
    """The scripted conversation; prompts follow the engine's own replies,
    new text comes from a fixed seed. Returns {label: (prompt, record)}."""
    rng = np.random.default_rng(0)

    def text(n):
        return [int(t) for t in rng.integers(1, 256, n)]

    new = {"a1": text(10), "a2": text(3), "a3": text(45), "a4": text(20),
           "long": text(50), "a5": text(6)}
    new.update({f"p{i}": text(5 + i % 7) for i in range(15)})
    new.update({f"p{i}.2": text(2) for i in (3, 8, 14)})
    new["p8.3"] = text(2)
    out = {}

    def turn(label, prompt, sid):
        out[label] = (prompt, _turn(engine, prompt, sid, sp_cls))
        return prompt + out[label][1][0]

    hist = turn("a1", new["a1"], "a")                 # 10 tokens
    hist = turn("a2", hist + new["a2"], "a")          # turn 2: 4 new rows
    hist = turn("a3", hist + new["a3"], "a")          # 46-token suffix: 2 pieces
    turn("a4", hist + new["a4"], "a")                 # near the end: single steps
    turn("long", new["long"], None)                   # sessionless, > 32 tokens
    turn("a5", new["a5"], "a")                        # diverged history
    hists = {}
    for i in range(15):                               # 16 sessions on 4 slots
        hists[i] = turn(f"p{i}", new[f"p{i}"], f"p{i}")
    for i in (3, 8, 14):
        hists[i] = turn(f"p{i}.2", hists[i] + new[f"p{i}.2"], f"p{i}")
    engine.release_session("p8")
    turn("p8.3", hists[8] + new["p8.3"], "p8")        # released: rebuilt
    return out


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _port_engine(tparams, **fields):
    return InferenceEngine(get_config("test-tiny"), EngineConfig(**fields),
                           params=tparams, seed=0, device="cpu")


@pytest.fixture(scope="module")
def runs(jparams, tparams):
    """name → (JAX engine, port engine, JAX script, port script, the port's
    sessions after it), run on demand: both engines run the same script."""
    cache = {}

    def run(name):
        if name not in cache:
            fields = dict(ENGINE_FIELDS, **KV_CONFIGS[name])
            jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields),
                           params=jparams, seed=0)
            teng = _port_engine(tparams, **fields)
            cache[name] = (jeng, teng, _script(jeng, JSamplingParams),
                           _script(teng, SamplingParams), sorted(teng._sessions))
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_script_identical_to_jax(runs, name):
    """Tokens, finish reasons and per-turn prefill / reuse / extend /
    offload / restore counts equal the JAX engine's, turn by turn."""
    _, _, jout, tout, _ = runs(name)
    assert list(tout) == list(jout)
    for label in jout:
        assert tout[label] == jout[label], label
    assert all(rec[1] in ("stop", "length") for _, rec in tout.values())


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_script_costs(runs, name):
    """What each turn of the script must cost, on the port."""
    _, teng, _, out, sessions = runs(name)

    def deltas(label):
        return out[label][1][2]

    a1, a2 = out["a1"], out["a2"]
    # Turn 2 prefills only its new text and the last reply token, whose
    # row is not known to be written.
    reused = len(a1[0]) + len(a1[1][0]) - 1
    assert deltas("a2")["prefix_reuse_tokens"] == reused
    assert deltas("a2")["prefill_tokens"] == len(a2[0]) - reused == 4
    assert deltas("a3")["extend_steps"] == 2           # 46 tokens: 32 + 14
    # a4 extends 21 tokens from row 69: while a 32-row piece would cross
    # max_seq the pieces are single tokens, then one piece of 16.
    assert teng._extend_pieces(69, 21) == [(r, 1, 1) for r in range(69, 74)] + [(74, 16, 16)]
    assert deltas("a4")["extend_steps"] == 6
    assert deltas("long")["extend_steps"] == 2 and deltas("long")["prefix_reuse_tokens"] == 0
    assert deltas("a5")["prefix_reuse_tokens"] == 0    # diverged: rebuilt
    assert deltas("p8.3")["prefix_reuse_tokens"] == 0  # released: rebuilt
    for i in (3, 14):
        assert deltas(f"p{i}.2")["prefix_reuse_tokens"] > 0
    m = teng.metrics
    assert m["session_offloads"] >= 11 and m["session_restores"] >= 2
    # The cap keeps the 12 most recently used sessions; "a" and p0–p2
    # went first (p8 was released and came back).
    assert sessions == sorted(f"p{i}" for i in range(3, 15))


@pytest.mark.parametrize("name", ["contiguous", "paged"])
def test_reused_turns_equal_fresh_engine(runs, tparams, name):
    """f32: a turn served on reused, restored or extended rows gives the
    tokens a fresh engine gives for the whole prompt."""
    _, _, _, out, _ = runs(name)
    fresh = _port_engine(tparams, **ENGINE_FIELDS, **KV_CONFIGS[name])
    for label in ("a2", "a3", "a4", "p3.2", "p14.2"):
        prompt, (toks, _, _) = out[label]
        assert _turn(fresh, prompt, None, SamplingParams)[0] == toks, label


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_payloads_cross_between_packages(runs, name):
    """One session exported from each engine and imported into the other:
    the JAX payload continues on the port, the port's on JAX, with the
    same next-turn tokens from the imported rows. JAX's engine takes only
    its own QuantKV class, so the port's int8 leaves are rewrapped."""
    jeng, teng, jout, _, _ = runs(name)
    jpay, tpay = jeng.export_session("p14"), teng.export_session("p14")
    assert isinstance(tpay, SessionExport) and tpay.restore_rows == jpay.restore_rows
    assert tpay.token_ids == jpay.token_ids and tpay.kv_quant == jpay.kv_quant
    if tkvq.is_quant_kv(tpay.host_k):
        tpay = dataclasses.replace(
            tpay, host_k=jkvq.QuantKV(tpay.host_k.q, tpay.host_k.s),
            host_v=jkvq.QuantKV(tpay.host_v.q, tpay.host_v.s))
    jeng.import_session(tpay)
    teng.import_session(jpay)
    prompt = jout["p14.2"][0] + jout["p14.2"][1][0] + [7, 7]
    jrec = _turn(jeng, prompt, "p14", JSamplingParams)
    trec = _turn(teng, prompt, "p14", SamplingParams)
    assert trec == jrec
    assert trec[2]["session_restores"] == 1
    assert trec[2]["prefix_reuse_tokens"] == len(jpay.token_ids)


def test_bf16_payload_round_trips_bit_exact(tparams):
    """bf16 rows leave as their 16-bit patterns and come back bit for bit:
    the importer's restored rows equal the exporter's, and its next turn
    equals the turn of an engine that kept the session resident."""
    fields = dict(ENGINE_FIELDS, dtype="bfloat16")
    params = jax.tree.map(lambda t: t.to(torch.bfloat16), tparams)
    a, b, kept = (_port_engine(params, **fields) for _ in range(3))
    p1 = list(range(1, 30))
    t1 = _turn(a, p1, "s", SamplingParams)[0]
    assert _turn(kept, p1, "s", SamplingParams)[0] == t1
    pay = a.export_session("s")
    assert pay.host_k.dtype == np.uint16
    b.import_session(pay)
    p2 = p1 + t1 + [9, 9, 9]
    restored = _turn(b, p2, "s", SamplingParams)
    assert restored[2]["session_restores"] == 1
    assert restored[:2] == _turn(kept, p2, "s", SamplingParams)[:2]
    slot, n = b._sessions["s"].slot, len(pay.token_ids)
    got = b._ck[:, slot, :n].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, pay.host_k[:, :n])


@pytest.mark.parametrize("quiesce", [20, 32])
def test_quiesce_row_writes_never_reach_a_freed_page(tparams, quiesce):
    """A finished session's slot keeps the pages below its quiesce row and
    parks its frozen decode row there: in the kept partial page (row 20)
    or, on a page boundary (row 32), in trash. Every free page is poisoned
    with NaN while another request decodes: none is written, and the
    session's next turn still equals a fresh engine's."""
    fields = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
                  dtype="float32", kv_pages=10, kv_page_tokens=16)
    eng = _port_engine(tparams, **fields)
    p1 = list(range(1, quiesce - MAX_TOKENS + 2))
    t1 = _turn(eng, p1, "s", SamplingParams)[0]
    assert len(eng._sessions["s"].token_ids) == quiesce
    assert len(eng._pages.slot_pages[eng._sessions["s"].slot]) == -(-quiesce // 16)
    free = list(eng._pages._free)
    for pool in (eng._ck.pool, eng._cv.pool):
        pool[:, free] = float("nan")
    # Sessionful, so the pages it takes stay its own after it finishes.
    h = eng.submit(list(range(50, 60)), SamplingParams(temperature=0.0, max_tokens=12),
                   session_id="other")
    while eng.step():
        pass
    h.collect_tokens(timeout=5)
    still_free = [p for p in free if p in eng._pages._free]
    assert still_free
    for pool in (eng._ck.pool, eng._cv.pool):
        assert torch.isnan(pool[:, still_free]).all()
        # The plain attention reads a page's rows past the position (its
        # mask zeroes their weight, not their NaN), so the next turn's
        # fresh page must not hold NaN.
        pool[:, still_free] = 0.0
    p2 = p1 + t1 + [5, 6]
    got = _turn(eng, p2, "s", SamplingParams)
    assert got[2]["prefix_reuse_tokens"] == quiesce
    fresh = _port_engine(tparams, **dict(fields, kv_pages=0))
    assert got[0] == _turn(fresh, p2, None, SamplingParams)[0]


def test_pool_pressure_offloads_idle_sessions(tparams):
    """A placement that needs more pages than are free offloads the least
    recently used idle session and serves; every page comes back when the
    sessions are released, the resident one's at once."""
    fields = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
                  dtype="float32", kv_pages=5, kv_page_tokens=16)
    eng = _port_engine(tparams, **fields)
    fresh = _port_engine(tparams, **dict(fields, kv_pages=0))
    p = list(range(1, 31))
    _turn(eng, p, "s", SamplingParams)                  # holds 3 of 4 pages
    q = list(range(40, 60))
    toks = _turn(eng, q, "t", SamplingParams)           # needs 2: reclaims "s"
    assert eng.metrics["session_offloads"] == 1
    assert toks[0] == _turn(fresh, q, None, SamplingParams)[0]
    assert eng.metrics["kv_pages_free"] == 2            # "t" keeps 2 pages
    eng.release_session("s")
    eng.release_session("t")
    assert eng.metrics["kv_pages_free"] == eng.metrics["kv_pages_total"] == 4


def test_host_paging_helpers_match_jax():
    """gather_slot / gather_rows / cache_take and the host format against
    the JAX package's on the same pool, table and cache."""
    rng = np.random.default_rng(1)
    L, P, PS, H, D, B, NP = 2, 9, 4, 2, 8, 2, 4
    pool = rng.standard_normal((L, P, PS, H, D)).astype(np.float32)
    table = np.array([[3, 1, 0, 0], [5, 2, 7, 8]], np.int32)
    for quant in (False, True):
        jpool = jkvq.quantize_rows_np(pool) if quant else pool
        tpool = tkvq.quantize_rows_np(pool) if quant else pool
        jc = jpkv.PagedKV(jax.tree.map(jnp.asarray, jpool), jnp.asarray(table))
        tc = tpkv.PagedKV(tkvq.kv_map(torch.from_numpy, tpool), torch.from_numpy(table))
        for slot in range(B):
            want = jkvq.kv_host(jpkv.gather_slot(jc, slot))
            got = tkvq.kv_host(tpkv.gather_slot(tc, slot))
            for w, g in zip(jax.tree.leaves(want), (got.q, got.s) if quant else (got,)):
                np.testing.assert_array_equal(g, w)
            for rows in (1, 4, 7, 16):
                want = jkvq.kv_host(jpkv.gather_rows(jc, slot, rows))
                got = tkvq.kv_host(tpkv.gather_rows(tc, slot, rows))
                for w, g in zip(jax.tree.leaves(want), (got.q, got.s) if quant else (got,)):
                    np.testing.assert_array_equal(g, w)
    cache = rng.standard_normal((L, B, 16, H, D)).astype(np.float32)
    for starts, sizes in (((0, 1, 0), (L, 1, 8)), ((0, 1, 12), (L, 1, 8))):
        want = np.asarray(jkvq.cache_take(jnp.asarray(cache), starts, sizes))
        got = tkvq.kv_host(tkvq.cache_take(torch.from_numpy(cache), starts, sizes))
        np.testing.assert_array_equal(got, want)
    bf = torch.from_numpy(cache).to(torch.bfloat16)
    host = tkvq.kv_host(bf)
    assert host.dtype == np.uint16
    assert torch.equal(tkvq.kv_device(host, "cpu"), bf)
    jbf = jkvq.kv_host(jnp.asarray(cache, jnp.bfloat16))      # ml_dtypes bfloat16
    assert torch.equal(tkvq.kv_device(jbf, "cpu"), bf)


def test_types_match_jax():
    jf = [f.name for f in dataclasses.fields(JSessionExport)]
    assert [f.name for f in dataclasses.fields(SessionExport)] == jf
    for fields in (dict(), dict(prefill_buckets=(8, 16, 32), max_seq=96),
                   dict(prefill_buckets=(2048,), max_seq=1024)):
        jc, tc = JEngineConfig(**fields), EngineConfig(**fields)
        assert tc.restore_buckets() == jc.restore_buckets()
        assert [tc.restore_bucket_for(n) for n in (1, 33, 96)] == \
               [jc.restore_bucket_for(n) for n in (1, 33, 96)]


# -- two port engines behind the JAX package's coordinator --------------------


def _coord_drive(workers, handle):
    deadline = time.monotonic() + 60
    toks = []
    while time.monotonic() < deadline:
        for w in workers:
            w.step()
        while not handle._queue.empty():
            ev = handle._queue.get_nowait()
            if ev.token_id is not None:
                toks.append(ev.token_id)
            if ev.is_final:
                return toks, ev
    raise AssertionError("coordinator stream did not finish")


def test_coordinator_affinity_and_migration(runs, tparams):
    """Session affinity sends turn 2 to the worker holding the rows;
    remove_worker(migrate=True) drains that worker and carries the idle
    session to the survivor, which restores it and gives turn 3 the JAX
    engine's tokens."""
    jeng = runs("contiguous")[0]
    workers = [_port_engine(tparams, **ENGINE_FIELDS) for _ in range(2)]
    coord = EngineCoordinator(workers)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    prompts, hist = [list(range(1, 12)), [7, 8, 9], [10, 11]], []
    got = []
    for i, new in enumerate(prompts):
        if i == 2:
            summary = coord.remove_worker(first, migrate=True)
            assert summary["migrated"] == 1 and summary["fallbacks"] == 0
        hist = hist + new
        toks, fin = _coord_drive(workers, coord.submit(hist, sp, session_id="mig"))
        assert fin.finish_reason.value == "length"
        got.append(toks)
        if i == 0:
            first = coord.worker_for("mig")
        if i == 1:
            assert coord.worker_for("mig") == first
            assert workers[first].metrics["prefix_reuse_tokens"] > 0
        hist = hist + toks
    survivor = workers[1 - first]
    assert coord.worker_for("mig") == 1 - first
    m = survivor.metrics
    assert m["session_imports"] == 1 and m["session_restores"] == 1
    assert m["prefix_reuse_tokens"] > 0
    want, hist = [], []
    for new in prompts:
        hist = hist + new
        want.append(_turn(jeng, hist, "mig-ref", JSamplingParams)[0])
        hist = hist + want[-1]
    assert got == want
