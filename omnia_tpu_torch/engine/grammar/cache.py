"""Content-addressed grammar compile cache (the port's copy of the JAX
package's, with counters of its own).

The expensive artifact (a compiled :class:`TokenGrammar`) is keyed by a
digest of everything that determines it — the grammar source spec and the
tokenizer fingerprint — so the key is **stable across processes** (no
id()s, no dict-order dependence, no timestamps), and equal to the JAX
package's key for the same spec and tokenizer.

The in-process tier is a bounded LRU — by entry count and by total
host-memory footprint (a retained grammar holds its token table plus
memoized sampler views, O(states × vocab) int32 each); hit/miss
counters feed the engine's ``grammar_compile_hits``/
``grammar_compile_misses`` metrics.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Optional, Sequence

from omnia_tpu_torch.engine.grammar.fsm import (
    GrammarTooLarge,
    GrammarUnsupported,
    NfaBuilder,
    TokenGrammar,
    determinize,
)
from omnia_tpu_torch.engine.grammar.jsonfsm import (
    schema_fragment,
    turn_start_and_accepts,
)
from omnia_tpu_torch.engine.grammar.regex import regex_fragment

MAX_CACHED = 128
MAX_CACHED_BYTES = 1 << 30

_lock = threading.Lock()
_cache: "OrderedDict[str, TokenGrammar]" = OrderedDict()
stats = {"hits": 0, "misses": 0}


def tokenizer_fingerprint(tokenizer) -> dict:
    """What the token table depends on. Class name + vocab/special ids is
    exact for the in-tree tokenizers (ByteTokenizer has no free state);
    HF tokenizers add their name_or_path when available."""
    fp = {
        "class": type(tokenizer).__name__,
        "vocab_size": int(tokenizer.vocab_size),
        "bos_id": int(getattr(tokenizer, "bos_id", -1)),
        "eos_id": int(getattr(tokenizer, "eos_id", -1)),
    }
    inner = getattr(tokenizer, "_tok", None)
    path = getattr(inner, "name_or_path", None)
    if path:
        fp["path"] = str(path)
    return fp


def grammar_cache_key(kind: str, spec, tokenizer) -> str:
    """Deterministic content address of a compile request.

    ``json.dumps(sort_keys=True)`` canonicalizes dict ordering, so two
    logically-equal specs produce one key regardless of construction
    order — the key-stability contract the guards suite pins."""
    payload = {
        "v": 1,
        "kind": kind,
        "spec": spec,
        "tokenizer": tokenizer_fingerprint(tokenizer),
    }
    try:
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                          ensure_ascii=True)
    except (TypeError, ValueError) as e:
        # A handler-supplied schema holding a set/callable/etc. cannot be
        # content-addressed (or compiled) — refuse so callers take their
        # documented post-hoc fallback instead of crashing the turn.
        raise GrammarUnsupported(
            f"grammar spec is not JSON-serializable: {e}") from None
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _get(key: str) -> Optional[TokenGrammar]:
    with _lock:
        g = _cache.get(key)
        if g is not None:
            _cache.move_to_end(key)
            stats["hits"] += 1
        else:
            stats["misses"] += 1
        return g


def _put(key: str, grammar: TokenGrammar) -> None:
    with _lock:
        _cache[key] = grammar
        _cache.move_to_end(key)
        while len(_cache) > MAX_CACHED or (
            len(_cache) > 1
            and sum(g.nbytes() for g in _cache.values()) > MAX_CACHED_BYTES
        ):
            _cache.popitem(last=False)


def _check_budget(g: TokenGrammar, max_states: int) -> TokenGrammar:
    """max_states is not part of the cache key (the automaton does not
    depend on it), so a hit must still enforce the CALLER's cap."""
    if g.num_states > max_states:
        raise GrammarTooLarge(
            f"grammar needs {g.num_states} states, caller budget is "
            f"{max_states}"
        )
    return g


def clear_cache() -> None:
    """Test hook: reset the cache and counters."""
    with _lock:
        _cache.clear()
        stats["hits"] = 0
        stats["misses"] = 0


def compile_regex(pattern: str, tokenizer,
                  max_states: int = 8192) -> TokenGrammar:
    """Regex (fullmatch semantics) → TokenGrammar, cached."""
    key = grammar_cache_key("regex", pattern, tokenizer)
    g = _get(key)
    if g is not None:
        return _check_budget(g, max_states)
    b = NfaBuilder()
    frag = regex_fragment(b, pattern)
    dfa = determinize(b, frag.start, {frag.end}, max_states=max_states)
    g = TokenGrammar(dfa, tokenizer, key=key)
    _put(key, g)
    return g


def compile_json_schema(schema: Optional[dict], tokenizer,
                        max_states: int = 8192) -> TokenGrammar:
    """JSON Schema (None = any bounded JSON value) → TokenGrammar."""
    return compile_turn_grammar(
        {"type": "json_schema", "schema": schema} if schema
        else {"type": "json"},
        (), tokenizer, max_states=max_states)


def compile_turn_grammar(
    response_format: Optional[dict],
    tools: Sequence[dict],
    tokenizer,
    max_states: int = 8192,
) -> Optional[TokenGrammar]:
    """The runtime's one entry point: the grammar for a whole turn —
    response_format branch and/or tool-call branch (jsonfsm module doc).
    Returns None when there is nothing to constrain. Raises
    GrammarUnsupported when any declared piece cannot be enforced
    (all-or-nothing: the caller then keeps post-hoc validation only)."""
    rf = response_format \
        if response_format and response_format.get("type") in ("json", "json_schema") \
        else None
    tool_spec = sorted(
        (
            {"name": t.get("name", ""),
             "input_schema": t.get("input_schema")}
            for t in tools if t.get("name")
        ),
        key=lambda t: t["name"],
    )
    if rf is None and not tool_spec:
        return None
    key = grammar_cache_key(
        "turn", {"response_format": rf, "tools": tool_spec}, tokenizer)
    g = _get(key)
    if g is not None:
        return _check_budget(g, max_states)
    b = NfaBuilder()
    start, accepts = turn_start_and_accepts(b, rf, tool_spec)
    dfa = determinize(b, start, accepts, max_states=max_states)
    g = TokenGrammar(dfa, tokenizer, key=key)
    _put(key, g)
    return g


__all__ = [
    "compile_json_schema",
    "compile_regex",
    "compile_turn_grammar",
    "grammar_cache_key",
    "clear_cache",
    "stats",
    "schema_fragment",
]
