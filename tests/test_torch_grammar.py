"""Grammar-constrained decoding in the port held against the JAX package
on the CPU: the port's own grammar compiler gives the JAX compiler's
tables entry for entry; greedy grammared streams, finish reasons and the
grammar metrics equal the JAX engine's on the contiguous and the int8 +
paged caches (the same converted ``test-tiny`` f32 params); sampled
grammared streams stay on the FSM and parse; a grammar compiled by the
JAX package serves alike; refusals carry the JAX engine's text."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest

from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine import grammar as jgr
from omnia_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine import EngineConfig, FinishReason, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import grammar as tgr
from omnia_tpu_torch.engine.tokenizer import ByteTokenizer
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax

TOK, JTOK = ByteTokenizer(), JByteTokenizer()
# Byte 0 is never admissible inside these grammars, so it plays EOS for
# the 256-token test model (ByteTokenizer's own eos id lies past it).
STOP = (0,)
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"}, "ok": {"type": "boolean"}},
          "required": ["a", "ok"]}
TOOL_CALL = {"type": "object",
             "properties": {"tool": {"enum": ["search", "calc", "weather"]},
                            "args": {"type": "object",
                                     "properties": {"unit": {"enum": ["c", "f"]},
                                                    "verbose": {"type": "boolean"}},
                                     "required": ["unit", "verbose"]}},
             "required": ["tool", "args"]}
SPECS = {
    "integer_boolean": ("json", SCHEMA),
    "tool_call": ("json", TOOL_CALL),
    "array": ("json", {"type": "array", "items": {"type": "integer"}, "maxItems": 3}),
    "string_number": ("json", {"type": "object",
                               "properties": {"name": {"type": "string", "maxLength": 8},
                                              "n": {"type": "number"}},
                               "required": ["name"]}),
    "generic_json": ("json", None),
    "regex": ("regex", r"[a-z]{2,5}-\d+"),
    "turn_tools": ("turn", [{"name": "echo", "input_schema": {
        "type": "object", "properties": {"text": {"enum": ["hi", "yo"]}},
        "required": ["text"]}}]),
}
ENGINE_FIELDS = dict(num_slots=2, max_seq=128, prefill_buckets=(16, 64), decode_chunk=4,
                     dtype="float32", max_sessions=4, grammar=True, grammar_max_states=128)
KV_CONFIGS = {
    "contiguous": dict(),
    "int8_paged": dict(kv_quant="int8", kv_pages=17, kv_page_tokens=16),
}
METRICS = ("grammar_rejections_avoided", "masked_logit_fraction", "tokens_generated")


def _compile(pkg, tok, kind, spec):
    if kind == "json":
        return pkg.compile_json_schema(spec, tok)
    if kind == "regex":
        return pkg.compile_regex(spec, tok)
    return pkg.compile_turn_grammar(None, spec, tok)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tables_equal_jax(name):
    """The port's compiled view for the model vocab and stop ids equals
    the JAX package's, entry for entry, with the same cache key."""
    kind, spec = SPECS[name]
    t, j = _compile(tgr, TOK, kind, spec), _compile(jgr, JTOK, kind, spec)
    assert t.key == j.key and t.eos_id == j.eos_id
    for vocab, stops in ((256, STOP), (300, ())):
        tv, jv = t.view(vocab, stops), j.view(vocab, stops)
        assert np.array_equal(tv.table, jv.table)
        assert np.array_equal(tv.accepting, jv.accepting) and tv.start == jv.start


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jget_config("test-tiny"), jax.random.key(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _port(tparams, **fields):
    return InferenceEngine(get_config("test-tiny"), EngineConfig(**dict(ENGINE_FIELDS, **fields)),
                           params=tparams, seed=0, device="cpu")


def _drive(engine, subs, sp_cls, grammars):
    """Submit every request at once, step inline → [(tokens, finish)]."""
    handles = [engine.submit(p, sp_cls(temperature=0.0, max_tokens=n, stop_token_ids=STOP),
                             session_id=sid, grammar=grammars.get(g))
               for p, n, sid, g in subs]
    while engine.step():
        pass
    return [(lambda t, f: (t, f.finish_reason.value))(*h.collect_tokens(timeout=5))
            for h in handles]


def _requests():
    """Grammared and free requests sharing the batch, a session's second
    turn under a grammar, more requests than slots."""
    rng = np.random.default_rng(1)

    def text(n):
        return [int(t) for t in rng.integers(1, 256, n)]

    return [(text(9), 80, "g1", "schema"), (text(20), 6, None, None),
            (text(5), 80, None, "tool_call"), (text(12), 60, "g2", "regex"),
            (text(30), 80, "g1", "schema"), (text(7), 80, None, "tool_call")]


@pytest.fixture(scope="module")
def runs(jparams, tparams):
    cache = {}

    def run(name):
        if name not in cache:
            fields = dict(ENGINE_FIELDS, **KV_CONFIGS[name])
            jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields), params=jparams,
                           seed=0)
            teng = _port(tparams, **KV_CONFIGS[name])
            jg = {k: _compile(jgr, JTOK, *SPECS[s]) for k, s in
                  (("schema", "integer_boolean"), ("tool_call", "tool_call"),
                   ("regex", "regex"))}
            tg = {k: _compile(tgr, TOK, *SPECS[s]) for k, s in
                  (("schema", "integer_boolean"), ("tool_call", "tool_call"),
                   ("regex", "regex"))}
            subs = _requests()
            cache[name] = (_drive(jeng, subs, JSamplingParams, jg),
                           _drive(teng, subs, SamplingParams, tg),
                           {k: jeng.metrics[k] for k in METRICS},
                           {k: teng.metrics[k] for k in METRICS}, teng, tg)
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_greedy_streams_identical_to_jax(runs, name):
    """Tokens, finish reasons and the grammar metrics equal the JAX
    engine's; every grammared request stops in an accepting state."""
    jout, tout, jm, tm, _, _ = runs(name)
    assert tout == jout
    assert tm == jm
    grammared = [i for i, r in enumerate(_requests()) if r[3]]
    assert all(tout[i][1] == "stop" for i in grammared)
    assert tm["grammar_rejections_avoided"] == len(grammared)


def test_grammared_output_parses(runs):
    _, tout, _, _, _, _ = runs("contiguous")
    for (toks, _), (_, _, _, g) in zip(tout, _requests()):
        if g == "schema":
            jsonschema.validate(json.loads(TOK.decode(toks)), SCHEMA)
        elif g == "tool_call":
            jsonschema.validate(json.loads(TOK.decode(toks)), TOOL_CALL)


@pytest.mark.parametrize("name", sorted(KV_CONFIGS))
def test_sampled_streams_stay_on_the_fsm(runs, name):
    """Sampled grammared tokens (three seeds, a free request beside them)
    are each admissible from the host walk's state, end STOP in an
    accepting state and parse."""
    *_, eng, tg = runs(name)
    g = tg["tool_call"]
    view = g.view(eng.model_cfg.vocab_size, STOP)
    handles = [eng.submit(TOK.encode(f"call {i}", add_bos=False), SamplingParams(
        temperature=1.0, top_p=0.9, max_tokens=80, stop_token_ids=STOP, seed=i), grammar=g)
        for i in range(3)]
    free = eng.submit([5, 6, 7], SamplingParams(temperature=1.0, max_tokens=10, seed=9))
    while eng.step():
        pass
    for h in handles:
        toks, fin = h.collect_tokens(timeout=5)
        s = view.start
        for t in toks:
            s = view.advance(s, t)
            assert s >= 0
        assert fin.finish_reason == FinishReason.STOP and view.is_accepting(s)
        jsonschema.validate(json.loads(TOK.decode(toks)), TOOL_CALL)
    assert len(free.collect_tokens(timeout=5)[0]) == 10


def test_jax_compiled_grammar_serves_alike(tparams):
    """The runtime hands the engine a grammar compiled by the JAX
    package: the port duck-types it and gives the tokens of its own."""
    out = []
    for pkg, tok in ((jgr, JTOK), (tgr, TOK)):
        eng = _port(tparams)
        g = _compile(pkg, tok, *SPECS["tool_call"])
        out.append(_drive(eng, [([9, 8, 7, 6], 80, None, "g")], SamplingParams, {"g": g}))
    assert out[0] == out[1] and out[0][0][1] == "stop"


def test_refusals_match_jax(jparams, tparams):
    """An over-budget grammar, and any grammar on an engine built with
    grammar=False, end at submit with the JAX engine's ERROR text; a
    grammar=False engine reports no grammar support."""
    big = (_compile(jgr, JTOK, "json", None), _compile(tgr, TOK, "json", None))
    small = (_compile(jgr, JTOK, "regex", SPECS["regex"][1]),
             _compile(tgr, TOK, "regex", SPECS["regex"][1]))
    got = {}
    for off in (False, True):
        fields = dict(ENGINE_FIELDS, grammar=not off)
        jeng = JEngine(jget_config("test-tiny"), JEngineConfig(**fields), params=jparams, seed=0)
        teng = _port(tparams, grammar=not off)
        g = small if off else big
        for key, eng, gr, sp in (("jax", jeng, g[0], JSamplingParams), ("port", teng, g[1],
                                                                          SamplingParams)):
            ev = eng.submit([1, 2, 3], sp(stop_token_ids=STOP), grammar=gr).get_event(timeout=5)
            got[key, off] = (ev.finish_reason.value, ev.error, ev.num_prompt_tokens,
                             eng.supports_grammar())
    assert got["port", False] == got["jax", False]
    assert got["port", True] == got["jax", True]
    assert got["port", False][0] == "error" and "grammar_max_states" in got["port", False][1]
    assert got["port", True][1] == "grammar-constrained request on an engine built with grammar=off"
