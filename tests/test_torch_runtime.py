"""The JAX package's runtime served by the port's engine on the CPU: a
``Conversation`` turn and a ``RuntimeServer`` Invoke over a port engine
built with ``finish_reasons=omnia_tpu.engine.types.FinishReason`` give
the text, usage and finish reasons they give over the JAX engine (the
same converted ``test-tiny`` f32 params, widened to the byte tokenizer's
259 ids). The conversation reaches ``register_prefix`` and attaches its
turn grammar; an ERROR terminal surfaces as ``engine_error`` and a user
cancel as ``cancelled``; two port workers behind the JAX
``EngineCoordinator`` resubmit a zero-token ERROR. The runtime's bring-up
builds a port engine with its cold-start tracker (Health reads
``initializing`` with the warmup snapshot, then ready), a Converse turn's
engine span joins the llm span's trace, ``bind_engine_metrics`` exposes
the port's flight histograms, and the port engine's metric keys are the
JAX engine's, the decode ring's included."""

from __future__ import annotations

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.coordinator import EngineCoordinator
from omnia_tpu.engine.tokenizer import ByteTokenizer
from omnia_tpu.engine.types import FinishReason as JFinishReason
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.runtime import contract as c
from omnia_tpu.runtime.context_store import InMemoryContextStore
from omnia_tpu.runtime.conversation import Conversation, render_system_block
from omnia_tpu.runtime.packs import load_pack
from omnia_tpu.runtime.providers import ProviderRegistry, ProviderSpec
from omnia_tpu.runtime.server import RuntimeServer
from omnia_tpu.utils import tracing as tr
from omnia_tpu.utils.metrics import Registry, bind_engine_metrics
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine.coldstart import PHASE_CODES
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.runtime.providers import build_engine
from omnia_tpu_torch.utils.timeline import TIMELINE_KEYS

VOCAB = 259   # ByteTokenizer: 256 bytes, BOS, EOS, PAD
TOK = ByteTokenizer()
ENGINE_FIELDS = dict(num_slots=2, max_seq=256, prefill_buckets=(32, 64, 128, 256),
                     decode_chunk=4, dtype="float32", prefix_cache_slots=2,
                     prefix_cache_min_tokens=8, grammar=True, grammar_max_states=128)
SCHEMA = {"type": "object",
          "properties": {"tool": {"enum": ["a", "b"]}, "ok": {"type": "boolean"}},
          "required": ["tool", "ok"]}
PACK = {
    "name": "port-agent",
    "version": "1.0.0",
    "prompts": {"system": "You are {{persona}}, a terse assistant.",
                "greeting": "hello!"},
    "params": {"persona": {"type": "string", "default": "helpful"}},
    "sampling": {"temperature": 0.0, "max_tokens": 32},
    "functions": [{"name": "classify",
                   "input_schema": {"type": "object", "required": ["text"]},
                   "output_schema": {"type": "object", "required": ["label"]},
                   "prompt": "Classify: {{input}}"}],
}


@pytest.fixture(scope="module", autouse=True)
def manifest_dir(tmp_path_factory):
    """Every engine here keeps its warmup manifests in a directory of the
    test run's own, never in the package's build cache."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        d = tmp_path_factory.mktemp("manifests")
        monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny", vocab_size=VOCAB, max_seq_len=256),
                              jax.random.key(4), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _jax_engine(jparams, **fields):
    return JEngine(jget_config("test-tiny", vocab_size=VOCAB, max_seq_len=256),
                   JEngineConfig(**dict(ENGINE_FIELDS, **fields)), params=jparams, seed=0)


def _port_engine(tparams, **fields):
    return InferenceEngine(get_config("test-tiny", vocab_size=VOCAB, max_seq_len=256),
                           EngineConfig(**dict(ENGINE_FIELDS, **fields)), params=tparams,
                           seed=0, device="cpu", finish_reasons=JFinishReason)


def _conversation(engine, session):
    return Conversation(session_id=session, pack=load_pack(PACK), engine=engine,
                        tokenizer=TOK, store=InMemoryContextStore(),
                        provider_spec=ProviderSpec(name="main", type="tpu", model="test-tiny"))


def _turn(conv, **msg):
    """One turn, messages reduced to what a client reads."""
    return [(m.type, m.text, m.finish_reason, m.error_code, m.error_message,
             (m.usage.prompt_tokens, m.usage.completion_tokens) if m.usage else None)
            for m in conv.stream(c.ClientMessage(**msg))]


def _serve_turns(engine):
    """Two sessions of the pack, the second seeded from the first's
    system block; then a json_schema turn, constrained by the grammar."""
    engine.start()
    try:
        a, b = _conversation(engine, "a"), _conversation(engine, "b")
        out = [_turn(a, content="what is the weather?"),
               _turn(b, content="tell me a story"),
               _turn(a, content="and tomorrow?"),
               _turn(b, content="answer in json",
                     response_format={"type": "json_schema", "schema": SCHEMA})]
    finally:
        engine.stop()
    m = engine.metrics
    return out, {k: m[k] for k in ("prefix_cache_hit_tokens", "prefix_cache_insertions",
                                   "prefix_reuse_tokens", "grammar_rejections_avoided",
                                   "tokens_generated")}


@pytest.fixture(scope="module")
def turns(jparams, tparams):
    return _serve_turns(_jax_engine(jparams)), _serve_turns(_port_engine(tparams))


def test_conversation_turns_equal_jax(turns):
    """Text chunks, usage and finish reasons of every turn, and the
    prefix / grammar counts behind them, equal the JAX engine's."""
    (jout, jm), (tout, tm) = turns
    assert tout == jout
    assert tm == jm
    assert all(t[-1][0] == "done" and t[-1][2] == "stop" for t in tout)


def test_prefix_registered_and_grammar_attached(turns, tparams):
    """Conversation registers the pack's system block (the second
    session then seeds it), and the json_schema turn is served under a
    grammar: it stops in an accepting state and parses."""
    (_, _), (tout, tm) = turns
    block = TOK.encode(render_system_block(load_pack(PACK), {}))
    assert tm["prefix_cache_insertions"] >= 1
    assert tm["prefix_cache_hit_tokens"] >= len(block)
    assert tm["grammar_rejections_avoided"] == 1
    text = "".join(m[1] for m in tout[3] if m[0] == "chunk")
    assert set(json.loads(text)) == {"tool", "ok"}
    eng = _port_engine(tparams)
    _conversation(eng, "x")
    assert eng._prefix_pool._registered == [tuple(block)]
    assert eng.supports_grammar()


def _step_turn(engine, conv, before_step=None, **msg):
    """Run a turn on a thread while this thread steps the engine inline;
    ``before_step(conv)`` runs once the turn's request is submitted."""
    out = []
    th = threading.Thread(target=lambda: out.extend(_turn(conv, **msg)))
    th.start()
    deadline = time.monotonic() + 30
    while conv._active_handle is None and th.is_alive() and time.monotonic() < deadline:
        time.sleep(0.001)
    if before_step is not None:
        before_step(conv)
    while th.is_alive() and time.monotonic() < deadline:
        try:
            engine.step()
        except RuntimeError:
            pass  # an injected placement fault: its handle got ERROR
        time.sleep(0.001)
    th.join(timeout=5)
    assert not th.is_alive()
    return out


def _failing_prefill(*_args, **_kw):
    raise RuntimeError("injected prefill fault")


@pytest.mark.parametrize("case", ["error", "cancel"])
def test_error_and_cancel_surface_as_in_jax(jparams, tparams, case):
    """An engine ERROR ends the turn with engine_error and a user cancel
    ends it with finish_reason "cancelled", over either engine."""
    got = []
    for eng in (_jax_engine(jparams), _port_engine(tparams)):
        conv = _conversation(eng, "s")
        if case == "error":
            eng._prefill_insert_fn = _failing_prefill
            got.append(_step_turn(eng, conv, content="hello"))
        else:
            got.append(_step_turn(eng, conv, before_step=lambda cv: cv.cancel_turn(),
                                  content="hello"))
    assert got[1] == got[0]
    last = got[1][-1]
    if case == "error":
        assert last[0] == "error" and last[3] == "engine_error"
        assert last[4] == "prefill failed"
    else:
        assert last[0] == "done" and last[2] == "cancelled"


class _Registry(ProviderRegistry):
    """A registry whose providers all resolve to one engine already built."""

    def __init__(self, engine):
        super().__init__()
        self.register(ProviderSpec(name="main", type="tpu", model="test-tiny"))
        self.register(ProviderSpec(name="infer", type="tpu", model="test-tiny",
                                   role="inference"))
        self._engine = engine

    def engine(self, name, coldstart=None):
        return self._engine


def _invokes(engine):
    server = RuntimeServer(pack=load_pack(PACK), providers=_Registry(engine),
                           provider_name="main")
    reqs = [c.InvokeRequest(name="classify", input={"text": "great product"}),
            c.InvokeRequest(name="inference.generate", input={"prompt": "Once upon",
                                                              "max_tokens": 9}),
            c.InvokeRequest(name="inference.generate", input={"prompt": "x" * 300})]
    return [server.invoke(r, None) for r in reqs]


def test_invoke_equals_jax(jparams, tparams):
    """Function mode and inference.generate run through engine.generate
    (stepped inline): the same outputs, usage and errors, and a prompt
    past the cache surfaces as engine_error."""
    jout, tout = _invokes(_jax_engine(jparams)), _invokes(_port_engine(tparams))
    assert tout == jout
    assert tout[1].output["finish_reason"] in ("stop", "length")
    assert tout[1].usage.completion_tokens <= 9
    assert tout[2].error_code == "engine_error" and "exceeds KV capacity" in tout[2].error_message


def test_build_engine_passes_the_enum_and_knobs():
    spec = ProviderSpec(name="p", model="test-tiny",
                        options={"num_slots": 2, "max_seq": 64, "prefill_buckets": [32],
                                 "dtype": "float32", "prefix_cache_slots": 2,
                                 "grammar": True, "grammar_max_states": 64})
    eng = build_engine(spec, device="cpu", finish_reasons=JFinishReason)
    assert eng.supports_grammar() and eng._prefix_pool is not None
    toks, fin = eng.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=3))
    assert fin.finish_reason is JFinishReason.LENGTH and len(toks) == 3
    assert eng.live_request_ids() == set()


def test_coordinator_resubmits_a_zero_token_error(jparams, tparams):
    """A session pinned to one port worker whose next placement fails
    there with a zero-token ERROR is resubmitted to the other worker,
    which prefills it afresh: the tokens a fresh JAX engine gives."""
    fields = dict(prefix_cache_slots=0, grammar=False)
    workers = [_port_engine(tparams, **fields) for _ in range(2)]
    coord = EngineCoordinator(workers)
    for w in workers:
        w.start()
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=6)
        first = list(range(1, 20))
        toks, fin = coord.submit(first, sp, session_id="r").collect_tokens(timeout=60)
        assert fin.finish_reason is JFinishReason.LENGTH
        pinned = coord.worker_for("r")
        workers[pinned]._prefill_insert_fn = _failing_prefill
        workers[pinned]._extend_fn = _failing_prefill
        second = first + toks + [30, 31, 32]
        got, fin = coord.submit(second, sp, session_id="r").collect_tokens(timeout=60)
    finally:
        for w in workers:
            w.stop()
    assert fin.finish_reason is JFinishReason.LENGTH
    assert coord.metrics["resubmits"] == 1
    assert workers[pinned].metrics["recoveries"] == 1
    jeng = _jax_engine(jparams, **fields)
    want, _ = jeng.generate(second, JSamplingParams(temperature=0.0, max_tokens=6))
    assert got == want


# The decode ring's metric keys: the port engine has them too.
RING_KEYS = {"decode_ring_enabled", "decode_ring_gate_state", "early_exit_steps",
             "ring_drains", "ring_full_stalls"}


class _BuildingRegistry(ProviderRegistry):
    """Builds a port engine when the runtime's bring-up asks, with the
    tracker it passes; the engine's warmup waits for ``gate``."""

    def __init__(self, tparams, gate: threading.Event):
        super().__init__()
        self.register(ProviderSpec(name="main", type="tpu", model="test-tiny"))
        self._tparams, self._gate = tparams, gate
        self.built = threading.Event()

    def engine(self, name, coldstart=None):
        eng = self._engines.get(name)
        if eng is None:
            eng = self._engines[name] = InferenceEngine(
                get_config("test-tiny", vocab_size=VOCAB, max_seq_len=256),
                EngineConfig(**ENGINE_FIELDS, flight_events=256, warmup_threads=2),
                params=self._tparams, seed=0, device="cpu", finish_reasons=JFinishReason,
                coldstart=coldstart)
            warmup = eng.warmup

            def gated_warmup():
                self.built.set()
                assert self._gate.wait(timeout=60)
                warmup()

            eng.warmup = gated_warmup
        return eng


def test_serve_reports_initializing_then_ready(tparams, tmp_path, monkeypatch):
    """RuntimeServer.serve(wait_ready=False) over a port engine: while the
    warmup runs Health reads "initializing" with the tracker's snapshot
    (backend_init closed by the engine's construction), then "ok" with
    the engine ready and its warmup metrics mirrored."""
    monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(tmp_path))
    gate = threading.Event()
    reg = _BuildingRegistry(tparams, gate)
    server = RuntimeServer(pack=load_pack(PACK), providers=reg, provider_name="main")
    server.serve(wait_ready=False)
    try:
        assert reg.built.wait(timeout=60)
        h = server.health(None, None)
        assert h.status == "initializing"
        assert h.warmup["phase"] == "backend_init" and "backend_init" in h.warmup["phases_s"]
        gate.set()
        assert server.wait_ready(timeout=60)
        h = server.health(None, None)
        assert h.status == "ok"
        m = reg._engines["main"].metrics
        assert m["warmup_phase"] == PHASE_CODES["ready"]
        assert m["warmup_programs_done"] == m["warmup_programs_total"] > 0
        assert server._coldstart.snapshot()["phase"] == "ready"
    finally:
        gate.set()
        server.shutdown(grace=0)


def test_converse_engine_span_joins_the_llm_trace(tparams):
    """A turn through the runtime's conversation: the server hands its
    tracer to the port engine, and the engine's request span lands in
    the llm span's trace, under it."""
    tracer = tr.Tracer("runtime-test")
    engine = _port_engine(tparams, flight_events=256)
    server = RuntimeServer(pack=load_pack(PACK), providers=_Registry(engine),
                           provider_name="main", tracer=tracer)
    conv = server._get_or_create("traced")
    assert engine.tracer is tracer
    engine.start()
    try:
        msgs = _turn(conv, content="hello there")
    finally:
        engine.stop()
    assert msgs[-1][0] == "done"
    (llm,), (eng_span,) = tracer.spans(tr.SPAN_LLM), tracer.spans(tr.SPAN_ENGINE)
    assert eng_span.trace_id == llm.trace_id and eng_span.parent_id == llm.span_id
    assert eng_span.attrs["engine.tokens"] == msgs[-1][5][1]


def test_bind_engine_metrics_exposes_the_port_histograms(tparams):
    engine = _port_engine(tparams, flight_events=64)
    engine.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4))
    reg = Registry(prefix="omnia_facade")
    bind_engine_metrics(reg, engine)
    body = reg.expose()
    assert "omnia_engine_requests_finished 1" in body
    assert "omnia_engine_flight_enabled 1" in body
    assert "omnia_engine_ttft_seconds_count 1" in body
    assert "omnia_engine_dispatch_us_bucket" in body and "omnia_engine_sync_us_count" in body


@pytest.mark.parametrize("fields", [dict(), dict(flight_events=64, watchdog_s=5.0,
                                                 kv_quant="int8", kv_pages=33,
                                                 kv_page_tokens=16)])
def test_metric_keys_equal_jax_but_the_ring(jparams, tparams, fields):
    jkeys = set(_jax_engine(jparams, **fields).metrics)
    tkeys = set(_port_engine(tparams, **fields).metrics)
    assert tkeys == jkeys | TIMELINE_KEYS | {"prefill_graph_replays"}
    assert RING_KEYS <= tkeys
