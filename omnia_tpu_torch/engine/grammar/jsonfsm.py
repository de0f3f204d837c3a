"""JSON Schema / tool-call convention → byte-NFA fragments.

The compiler is **strict by construction**: a schema either compiles into
an automaton whose every admissible output validates under
``jsonschema.validate`` (and parses as JSON), or it raises
:class:`GrammarUnsupported` and the runtime falls back to post-hoc
validation. There is deliberately no "partially enforced" mode — that is
the only way the cross-check property ("with a grammar attached the
post-hoc validator can never fire") can hold universally.

Enforced subset (anything else refuses):

- ``type``: string / integer / number / boolean / null / object / array
  (or a list of those — alternation)
- ``enum`` / ``const`` over JSON-serializable values
- objects: declared ``properties`` are all emitted, in declaration order
  (validators are order-insensitive, so emitting the full declared set
  is sound and keeps the automaton linear); ``required`` must be a
  subset of ``properties``; ``additionalProperties`` is never emitted
- arrays: ``items`` + ``minItems``/``maxItems`` (bounded)
- strings: ``minLength``/``maxLength``, ``pattern`` (compiled through
  the in-tree regex engine; JSON-escaping-sensitive patterns refuse)
- numbers: ``minimum: 0`` compiles to a sign restriction; any other
  bound refuses (the FSM cannot count value magnitude)
- ``anyOf`` (alternation). ``oneOf`` refuses: an alternation mask can
  emit a value matching two branches, which *fails* oneOf.

Emitted JSON is compact (an optional single whitespace is allowed after
``:`` and ``,``) — canonical output keeps the automata small, and
validators do not care about whitespace.

Also here: the tool-call turn grammar — free text compiled as a
KMP-guarded automaton that, on completing the literal ``<tool_call>``
marker, hard-transitions into an alternation over the declared tools'
``{"name": ..., "arguments": <schema>}`` automata (the "hot-swap to the
invoked tool's argument schema" is the branch keyed by the name bytes),
then the close marker, then back to text.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from omnia_tpu_torch.engine.grammar.fsm import (
    Frag,
    GrammarUnsupported,
    NfaBuilder,
    mask_of,
    mask_range,
)
from omnia_tpu_torch.engine.grammar.regex import regex_fragment

TOOL_OPEN = b"<tool_call>"
TOOL_CLOSE = b"</tool_call>"

# Generic-JSON bounds (response_format {"type": "json"} and tools with no
# input_schema): nesting depth and members per container are bounded —
# an FSM cannot count arbitrary nesting, and every admitted output is
# still valid JSON, just not every valid JSON is admitted.
GENERIC_DEPTH = 2
GENERIC_MEMBERS = 5

_INT_DIGITS = 15    # |int part| ≤ 16 digits: bounded, avoids float overflow
_FRAC_DIGITS = 12
_EXP_DIGITS = 3

# Keywords that carry no validation semantics for emission.
_IGNORED_KEYS = {
    "title", "description", "default", "examples", "example", "$schema",
    "$id", "$comment", "deprecated", "readOnly", "writeOnly",
    "additionalProperties",  # we never emit undeclared properties
}


def _ws(b: NfaBuilder) -> Frag:
    """Optional single whitespace (after ':' / ',')."""
    return b.opt(b.cls(mask_of(b" \n\t")))


def _refuse(schema: dict, handled: set) -> None:
    extra = set(schema) - handled - _IGNORED_KEYS
    if extra:
        raise GrammarUnsupported(
            f"unsupported JSON-Schema keywords {sorted(extra)} "
            f"(cannot be FSM-enforced)"
        )


def _string_char(b: NfaBuilder) -> Frag:
    """One JSON string character: any UTF-8 char except '\"', '\\', '<'
    and controls, or a JSON escape sequence.

    '<' is excluded RAW (it stays expressible as ``\\u003c``) because the
    runtime's ToolCallStreamParser scans the undecoded text for the
    literal ``<tool_call>``/``</tool_call>`` markers: a raw marker inside
    a grammar-admitted string value would truncate or misparse otherwise
    valid output, breaking the "post-hoc validator can never fire"
    contract.

    Surrogate escapes (``\\uD800``–``\\uDFFF``) are refused entirely:
    JSON only sanctions them in high+low PAIRS, and a lone one decodes
    to an unpaired surrogate that blows up any downstream UTF-8 encode
    of the "valid" value. Astral chars stay expressible as raw UTF-8, so
    no decodable string is lost — and with pairs gone every admitted
    unit is exactly one decoded char, which keeps minLength's
    unit-counting exact."""
    plain = b.utf8_char(
        exclude_ascii=mask_of(b'"\\<') | mask_range(0x00, 0x1F))
    hexd = mask_range(0x30, 0x39) | mask_range(0x41, 0x46) | mask_range(0x61, 0x66)
    u_esc = b.alt(
        # first hex digit not d/D ⇒ not \uDxxx
        b.seq(b.lit(b"u"), b.cls(hexd & ~mask_of(b"dD")),
              b.cls(hexd), b.cls(hexd), b.cls(hexd)),
        # \uD[0-7]xx: D-prefixed escapes below the surrogate range
        b.seq(b.lit(b"u"), b.cls(mask_of(b"dD")),
              b.cls(mask_range(0x30, 0x37)),
              b.cls(hexd), b.cls(hexd)),
    )
    esc = b.seq(
        b.lit(b"\\"),
        b.alt(b.cls(mask_of(b'"\\/bfnrt')), u_esc),
    )
    return b.alt(plain, esc)


def _string_frag(b: NfaBuilder, schema: Optional[dict] = None) -> Frag:
    schema = schema or {}
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")  # None ⇒ unbounded (star — tiny NFA)
    if hi is not None and int(hi) < lo:
        raise GrammarUnsupported("maxLength < minLength")
    pattern = schema.get("pattern")
    if pattern is not None:
        # Refuse the combination BEFORE building either body: the repeat
        # NFA would be dead work, and its own bounds check could preempt
        # this (clearer) refusal for large maxLength.
        if "minLength" in schema or "maxLength" in schema:
            raise GrammarUnsupported("pattern combined with length bounds")
        # Leading ^ / trailing $ need no stripping: the regex compiler
        # treats them as fullmatch no-ops at those positions.
        # The automaton emits the JSON-ENCODED bytes; a pattern whose
        # LANGUAGE could contain bytes needing escapes ('"', '\\',
        # controls) would come out invalid. The forbid mask makes the
        # regex compiler prove disjointness (a `.` or `[^x]` admitting a
        # raw quote refuses) — source-text inspection alone would miss
        # those. '<' is forbidden for the same reason as in _string_char
        # (raw tool-call markers must be unrepresentable in strings).
        body = regex_fragment(
            b, pattern, forbid=mask_of(b'"\\<') | mask_range(0x00, 0x1F))
    else:
        body = b.repeat(_string_char(b),
                        lo, None if hi is None else int(hi))
    return b.seq(b.lit(b'"'), body, b.lit(b'"'))


def _number_frag(b: NfaBuilder, integer: bool, schema: dict) -> Frag:
    handled = {"type", "minimum"}
    _refuse(schema, handled)
    minimum = schema.get("minimum")
    if minimum is not None and minimum != 0:
        raise GrammarUnsupported(
            "numeric minimum other than 0 cannot be FSM-enforced")
    nonneg = minimum == 0
    digits = mask_range(0x30, 0x39)
    int_part = b.alt(
        b.lit(b"0"),
        b.seq(b.cls(mask_range(0x31, 0x39)),
              b.repeat(b.cls(digits), 0, _INT_DIGITS)),
    )
    parts = [] if nonneg else [b.opt(b.lit(b"-"))]
    parts.append(int_part)
    if not integer:
        frac = b.seq(b.lit(b"."), b.repeat(b.cls(digits), 1, _FRAC_DIGITS))
        # Exponent sign is free either way: a negative exponent scales
        # magnitude, not sign, so minimum=0 stays satisfied.
        exp = b.seq(
            b.cls(mask_of(b"eE")),
            b.opt(b.cls(mask_of(b"+-"))),
            b.repeat(b.cls(digits), 1, _EXP_DIGITS),
        )
        parts.append(b.opt(frac))
        parts.append(b.opt(exp))
    return b.seq(*parts)


def _matches_type(value, typ) -> bool:
    """jsonschema's type semantics (bool is NOT an integer; ints count
    as numbers). None/absent type matches anything."""
    if typ is None:
        return True
    if isinstance(typ, list):
        return any(_matches_type(value, t) for t in typ)
    if typ == "boolean":
        return isinstance(value, bool)
    if isinstance(value, bool):
        return False
    if typ == "integer":
        return isinstance(value, int)
    if typ == "number":
        return isinstance(value, (int, float))
    if typ == "string":
        return isinstance(value, str)
    if typ == "null":
        return value is None
    if typ == "object":
        return isinstance(value, dict)
    if typ == "array":
        return isinstance(value, list)
    return False


def _const_frag(b: NfaBuilder, value) -> Frag:
    try:
        data = json.dumps(value, ensure_ascii=False, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise GrammarUnsupported(f"non-JSON const/enum value: {e}") from None
    # In JSON '<' can only occur inside string literals, so a blanket
    # escape keeps the bytes valid JSON while making raw tool-call
    # markers unrepresentable (see _string_char).
    return b.lit(data.replace(b"<", b"\\u003c"))


def _object_frag(b: NfaBuilder, schema: dict, depth: int) -> Frag:
    handled = {"type", "properties", "required", "minProperties",
               "maxProperties"}
    _refuse(schema, handled)
    props = schema.get("properties", {})
    required = schema.get("required", [])
    unknown_req = [r for r in required if r not in props]
    if unknown_req:
        raise GrammarUnsupported(
            f"required properties without schemas: {unknown_req}")
    if not props and "minProperties" not in schema \
            and "maxProperties" not in schema:
        # Bare {"type": "object"}: JSON Schema admits ANY members
        # (additionalProperties defaults to true). Constraining to the
        # literal "{}" would be sound but starve the common permissive
        # tool-argument idiom — and be strictly worse than declaring no
        # schema at all (which gets generic_object via
        # tool_body_fragment).
        return generic_object(b, min(max(depth, 0), GENERIC_DEPTH))
    n = len(props)
    if schema.get("minProperties", 0) > n or \
            schema.get("maxProperties", n) < n:
        raise GrammarUnsupported(
            "min/maxProperties incompatible with emitting all declared "
            "properties")
    parts = [b.lit(b"{")]
    for i, (name, sub) in enumerate(props.items()):
        if i:
            parts.append(b.lit(b","))
            parts.append(_ws(b))
        parts.append(_const_frag(b, name))
        parts.append(b.lit(b":"))
        parts.append(_ws(b))
        parts.append(schema_fragment(b, sub, depth - 1))
    parts.append(b.lit(b"}"))
    return b.seq(*parts)


def _array_frag(b: NfaBuilder, schema: dict, depth: int) -> Frag:
    handled = {"type", "items", "minItems", "maxItems"}
    _refuse(schema, handled)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")  # None ⇒ unbounded
    if hi is not None and (int(hi) < lo or int(hi) > 64):
        raise GrammarUnsupported(f"array bounds [{lo},{hi}] unsupported")
    item_schema = schema.get("items", {})
    item = schema_fragment(b, item_schema, depth - 1)
    if hi == 0:
        body = b.epsilon()
    else:
        rest = b.repeat(
            b.seq(b.lit(b","), _ws(b), b.clone(item)),
            max(lo - 1, 0), None if hi is None else int(hi) - 1,
        )
        first_plus = b.seq(item, rest)
        body = first_plus if lo >= 1 else b.opt(first_plus)
    return b.seq(b.lit(b"["), body, b.lit(b"]"))


def _members(b: NfaBuilder, member: Frag) -> Frag:
    """``(member (, member)*)?`` — member COUNT is unbounded (a star, so
    the NFA stays tiny); only nesting DEPTH is what an FSM must bound."""
    return b.opt(b.seq(member, b.star(
        b.seq(b.lit(b","), _ws(b), b.clone(member)))))


def generic_value(b: NfaBuilder, depth: int = GENERIC_DEPTH) -> Frag:
    """Any JSON value, nesting-bounded (every output is valid JSON)."""
    scalars = b.alt(
        _string_frag(b),
        _number_frag(b, integer=False, schema={}),
        b.lit(b"true"), b.lit(b"false"), b.lit(b"null"),
    )
    if depth <= 0:
        return scalars
    member = b.seq(_string_frag(b), b.lit(b":"), _ws(b),
                   generic_value(b, depth - 1))
    obj = b.seq(b.lit(b"{"), _members(b, member), b.lit(b"}"))
    arr = b.seq(b.lit(b"["), _members(b, generic_value(b, depth - 1)),
                b.lit(b"]"))
    return b.alt(scalars, obj, arr)


def generic_object(b: NfaBuilder, depth: int = GENERIC_DEPTH) -> Frag:
    """Any JSON object, nesting-bounded (tools without input_schema)."""
    member = b.seq(_string_frag(b), b.lit(b":"), _ws(b),
                   generic_value(b, depth - 1))
    return b.seq(b.lit(b"{"), _members(b, member), b.lit(b"}"))


def schema_fragment(b: NfaBuilder, schema, depth: int = 6) -> Frag:
    """Compile one (sub)schema. ``depth`` bounds recursion so cyclic or
    deeply-nested schemas refuse instead of exploding."""
    if depth < 0:
        raise GrammarUnsupported("schema nests too deeply for the FSM")
    if schema is True or schema == {}:
        return generic_value(b)
    if not isinstance(schema, dict):
        raise GrammarUnsupported(f"unsupported schema node {schema!r}")
    if "enum" in schema:
        _refuse(schema, {"enum", "type"})
        # A sibling `type` also validates each emitted value: admit only
        # the members that satisfy it (emitting a non-matching member
        # would make the post-hoc validator fire under the grammar).
        values = [v for v in schema["enum"]
                  if _matches_type(v, schema.get("type"))]
        if not values:
            raise GrammarUnsupported("enum has no values matching its type")
        return b.alt(*[_const_frag(b, v) for v in values])
    if "const" in schema:
        _refuse(schema, {"const", "type"})
        if not _matches_type(schema["const"], schema.get("type")):
            raise GrammarUnsupported("const value violates its own type")
        return _const_frag(b, schema["const"])
    if "anyOf" in schema:
        _refuse(schema, {"anyOf"})
        return b.alt(*[schema_fragment(b, s, depth - 1)
                       for s in schema["anyOf"]])
    typ = schema.get("type")
    if isinstance(typ, list):
        return b.alt(*[
            schema_fragment(b, {**schema, "type": t}, depth) for t in typ
        ])
    if typ == "string":
        _refuse(schema, {"type", "minLength", "maxLength", "pattern"})
        return _string_frag(b, schema)
    if typ == "integer":
        return _number_frag(b, integer=True, schema=schema)
    if typ == "number":
        return _number_frag(b, integer=False, schema=schema)
    if typ == "boolean":
        _refuse(schema, {"type"})
        return b.alt(b.lit(b"true"), b.lit(b"false"))
    if typ == "null":
        _refuse(schema, {"type"})
        return b.lit(b"null")
    if typ == "object":
        return _object_frag(b, schema, depth)
    if typ == "array":
        return _array_frag(b, schema, depth)
    if typ is None:
        raise GrammarUnsupported(
            f"schema without a type/enum/const/anyOf: {sorted(schema)}")
    raise GrammarUnsupported(f"unsupported type {typ!r}")


# ---------------------------------------------------------------------------
# Tool-call turn grammar
# ---------------------------------------------------------------------------


def _kmp_fail(marker: bytes) -> list[int]:
    fail = [0] * len(marker)
    k = 0
    for i in range(1, len(marker)):
        while k and marker[i] != marker[k]:
            k = fail[k - 1]
        if marker[i] == marker[k]:
            k += 1
        fail[i] = k
    return fail


def tool_body_fragment(b: NfaBuilder, tools: Sequence[dict]) -> Frag:
    """``{"name": <tool>, "arguments": <that tool's schema>}`` — an
    alternation keyed by the name bytes: once the emitted name commits
    to one tool, only that tool's argument schema remains admissible
    (the FSM form of hot-swapping to the invoked tool's schema)."""
    branches = []
    for tool in tools:
        name = tool.get("name")
        if not name:
            continue
        schema = tool.get("input_schema")
        args = (schema_fragment(b, schema) if schema
                else generic_object(b))
        branches.append(b.seq(
            b.lit(b"{"), _ws(b),
            b.lit(b'"name":'), _ws(b), _const_frag(b, name),
            b.lit(b","), _ws(b),
            b.lit(b'"arguments":'), _ws(b), args, _ws(b),
            b.lit(b"}"),
        ))
    if not branches:
        raise GrammarUnsupported("no named tools to constrain")
    return b.alt(*branches)


def guarded_text_automaton(
    b: NfaBuilder, tools: Sequence[dict]
) -> tuple[int, set[int]]:
    """Free text with an enforced tool-call convention.

    Returns (start_state, accepting_states). Text states are the KMP
    progress states over ``<tool_call>``: any byte is allowed, but the
    byte that *completes* the marker hard-transitions into the tool-body
    automaton — inside the marker-progress chain each byte either
    advances the match or falls back per the KMP failure function, so
    the language is exactly (text without a complete marker | marker +
    valid tool JSON + close marker)*. All text states accept (the model
    may stop any time outside a tool call)."""
    marker = TOOL_OPEN
    fail = _kmp_fail(marker)
    k = len(marker)
    text = [b.state() for _ in range(k)]  # progress 0..k-1

    body = tool_body_fragment(b, tools)
    close = b.lit(TOOL_CLOSE)
    b.link(body.end, close.start)
    b.link(close.end, text[0])

    def fallback(i: int, byte: int) -> int:
        j = i
        while True:
            if marker[j] == byte:
                return j + 1
            if j == 0:
                return 0
            j = fail[j - 1]

    for i in range(k):
        targets: dict[int, int] = {}
        for byte in range(256):
            nxt = fallback(i, byte)
            targets.setdefault(nxt, 0)
            targets[nxt] |= 1 << byte
        for nxt, mask in targets.items():
            dst = body.start if nxt == k else text[nxt]
            b.edge(text[i], mask, dst)
    return text[0], set(text)


def turn_start_and_accepts(
    b: NfaBuilder,
    response_format: Optional[dict],
    tools: Sequence[dict],
) -> tuple[int, set[int]]:
    """The full turn grammar: union of the applicable branches.

    - ``response_format`` json/json_schema → the (whole-output) schema
      automaton.
    - tools, no response_format → the guarded-text automaton (free text
      with enforced tool-call payloads).
    - tools AND response_format → the schema branch, plus a bare
      ``<tool_call>...</tool_call>`` branch with NO surrounding text —
      free text would subsume the schema branch and void the format
      constraint, so under a response_format a tool round is marker-only.
    """
    start = b.state()
    accepts: set[int] = set()
    branched = False
    if response_format and response_format.get("type") in ("json", "json_schema"):
        schema = response_format.get("schema") \
            if response_format.get("type") == "json_schema" else None
        frag = (schema_fragment(b, schema) if schema
                else generic_value(b))
        b.link(start, frag.start)
        accepts.add(frag.end)
        branched = True
        if tools:
            body = tool_body_fragment(b, tools)
            call = b.seq(b.lit(TOOL_OPEN), body, b.lit(TOOL_CLOSE))
            b.link(start, call.start)
            accepts.add(call.end)
    elif tools:
        tstart, taccepts = guarded_text_automaton(b, tools)
        b.link(start, tstart)
        accepts |= taccepts
        branched = True
    if not branched:
        raise GrammarUnsupported("nothing to constrain this turn")
    return start, accepts
