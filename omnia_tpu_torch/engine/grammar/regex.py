"""Regex → byte-NFA fragment compiler for grammar-constrained decoding.

Supports the deterministic core of Python's syntax — literals, ``|``,
groups, ``* + ?``, bounded ``{m,n}``, ``.``, character classes, the
common escapes — with **fullmatch** semantics (the whole generation must
match). Features the FSM cannot enforce byte-exactly (backreferences,
lookaround, mid-pattern anchors) raise :class:`GrammarUnsupported`: the
compiler's contract is all-or-nothing, so a compiled mask is always
sound against ``re.fullmatch`` with ``re.DOTALL`` off and ASCII class
semantics (``\\d``/``\\w``/``\\s`` are ASCII, as with ``re.ASCII``).

Non-ASCII literals compile to their UTF-8 byte sequences; ``.`` and
negated classes compile to the well-formed-UTF-8 "any char" automaton,
so constrained output stays decodable text.
"""

from __future__ import annotations

from omnia_tpu_torch.engine.grammar.fsm import (
    Frag,
    GrammarUnsupported,
    NfaBuilder,
    mask_of,
    mask_range,
)

_DIGIT = mask_range(0x30, 0x39)
_WORD = _DIGIT | mask_range(0x41, 0x5A) | mask_range(0x61, 0x7A) | mask_of(b"_")
_SPACE = mask_of(b" \t\n\r\x0b\x0c")
_ASCII = mask_range(0x00, 0x7F)

_ESCAPE_CLASSES = {
    "d": _DIGIT,
    "w": _WORD,
    "s": _SPACE,
    "D": _ASCII & ~_DIGIT,
    "W": _ASCII & ~_WORD,
    "S": _ASCII & ~_SPACE,
}
_ESCAPE_CHARS = {
    "n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B, "0": 0x00,
    "a": 0x07, "b": 0x08,
}
_META = set("\\^$.|?*+()[]{}")


class _Parser:
    def __init__(self, b: NfaBuilder, pattern: str, forbid: int = 0):
        self.b = b
        self.src = pattern
        self.pos = 0
        # Bytes the surrounding context cannot represent literally (e.g.
        # '"', '\\' and controls inside a JSON string): every class is
        # intersected against them, `.`/negations exclude them, and a
        # literal hitting one refuses — source-text inspection alone
        # would miss a `.` or `[^x]` that can MATCH a forbidden byte.
        self.forbid = forbid

    def _cls(self, mask: int) -> Frag:
        mask &= ~self.forbid
        if not mask:
            raise self.error(
                "class matches only context-forbidden bytes")
        return self.b.cls(mask)

    def _lit_bytes(self, data: bytes) -> Frag:
        if any((1 << byte) & self.forbid for byte in data):
            raise self.error(
                f"literal {data!r} needs context-forbidden bytes")
        return self.b.lit(data)

    def error(self, msg: str) -> GrammarUnsupported:
        return GrammarUnsupported(
            f"regex {self.src!r} at {self.pos}: {msg}")

    def peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def take(self) -> str:
        c = self.peek()
        self.pos += 1
        return c

    # expr := term ('|' term)*
    def expr(self) -> Frag:
        terms = [self.term()]
        while self.peek() == "|":
            self.take()
            terms.append(self.term())
        return self.b.alt(*terms)

    def term(self) -> Frag:
        parts: list[Frag] = []
        while True:
            c = self.peek()
            if c in ("", "|", ")"):
                break
            parts.append(self.factor())
        return self.b.seq(*parts) if parts else self.b.epsilon()

    def factor(self) -> Frag:
        # Anchors: ^ at the very start / $ at the very end are no-ops
        # under fullmatch semantics; anywhere else they are unsupported.
        if self.peek() == "^":
            if self.pos == 0:
                self.take()
                return self.b.epsilon()
            raise self.error("mid-pattern ^ anchor")
        if self.peek() == "$":
            if self.pos == len(self.src) - 1:
                self.take()
                return self.b.epsilon()
            raise self.error("mid-pattern $ anchor")
        atom = self.atom()
        return self.quantify(atom)

    def quantify(self, atom: Frag) -> Frag:
        c = self.peek()
        if c == "*":
            self.take()
            out = self.b.star(atom)
        elif c == "+":
            self.take()
            out = self.b.plus(atom)
        elif c == "?":
            self.take()
            out = self.b.opt(atom)
        elif c == "{":
            save = self.pos
            self.take()
            spec = ""
            while self.peek() not in ("", "}"):
                spec += self.take()
            if self.peek() != "}":
                self.pos = save
                return atom  # literal '{'
            self.take()
            try:
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s) if lo_s else 0
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
            except ValueError:
                raise self.error(f"bad repeat spec {{{spec}}}") from None
            out = self.b.repeat(atom, lo, hi)
        else:
            return atom
        if self.peek() == "?":
            # Lazy modifier changes match PREFERENCE, not the language —
            # a mask has no preference, so accept & drop.
            self.take()
        elif self.peek() == "+":
            # Possessive quantifiers DO change the language (a*+a
            # matches nothing); dropping one would admit strings
            # re.fullmatch rejects.
            raise self.error("possessive quantifiers unsupported")
        return out

    def atom(self) -> Frag:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                nxt = self.peek()
                if nxt == ":":
                    self.take()
                elif nxt == "P":
                    self.take()
                    if self.take() != "<":
                        raise self.error("unsupported (?P...) form")
                    while self.peek() not in ("", ">"):
                        self.take()
                    if self.take() != ">":
                        raise self.error("unterminated group name")
                else:
                    raise self.error(f"unsupported (?{nxt}...) construct")
            inner = self.expr()
            if self.take() != ")":
                raise self.error("unbalanced parenthesis")
            return inner
        if c == "[":
            return self.char_class()
        if c == ".":
            # Python '.' (no DOTALL): any char but newline.
            return self.b.utf8_char(
                exclude_ascii=mask_of(b"\n") | self.forbid)
        if c == "\\":
            return self.escape()
        if c in _META and c not in ("{", "}"):
            raise self.error(f"unexpected metacharacter {c!r}")
        return self._lit_bytes(c.encode("utf-8"))

    def escape(self) -> Frag:
        c = self.take()
        if c == "":
            raise self.error("dangling backslash")
        if c in _ESCAPE_CLASSES:
            return self._cls(_ESCAPE_CLASSES[c])
        if c in ("b", "B"):
            # \b is a word BOUNDARY here (backspace only inside classes)
            # — a zero-width assertion the FSM cannot express.
            raise self.error(f"unsupported boundary assertion \\{c}")
        if c in _ESCAPE_CHARS:
            return self._lit_bytes(bytes([_ESCAPE_CHARS[c]]))
        if c == "x":
            hx = self.take() + self.take()
            try:
                if len(hx) != 2:
                    raise ValueError
                # \xNN names the CHARACTER chr(NN) (re semantics); for
                # NN >= 0x80 the matchable text is its UTF-8 encoding —
                # emitting the raw byte would produce undecodable output.
                return self._lit_bytes(chr(int(hx, 16)).encode("utf-8"))
            except ValueError:
                raise self.error(f"bad \\x escape {hx!r}") from None
        if c == "u":
            hx = "".join(self.take() for _ in range(4))
            try:
                if len(hx) != 4:
                    raise ValueError
                return self._lit_bytes(chr(int(hx, 16)).encode("utf-8"))
            except ValueError:
                raise self.error(f"bad \\u escape {hx!r}") from None
        if c in ("A", "Z", "B"):
            raise self.error(f"unsupported escape \\{c}")
        if c.isalnum():
            raise self.error(f"unsupported escape \\{c}")
        return self._lit_bytes(c.encode("utf-8"))

    def _class_byte(self) -> int:
        """One class member byte (for range endpoints)."""
        c = self.take()
        if c == "\\":
            e = self.take()
            if e in _ESCAPE_CHARS:
                return _ESCAPE_CHARS[e]
            if e == "x":
                hx = self.take() + self.take()
                try:
                    if len(hx) != 2:
                        raise ValueError
                    v = int(hx, 16)
                except ValueError:
                    raise self.error(f"bad \\x escape {hx!r}") from None
                if v > 127:
                    # Classes are ASCII byte masks; chr(v) >= 0x80 is a
                    # multi-byte UTF-8 sequence, not a single class byte.
                    raise self.error(
                        "non-ASCII characters in classes unsupported")
                return v
            if e in _ESCAPE_CLASSES:
                return -1  # signal: class escape, handled by caller
            if e and not e.isalnum():
                return ord(e) if ord(e) < 128 else -2
            raise self.error(f"unsupported class escape \\{e}")
        if c == "":
            raise self.error("unterminated character class")
        if ord(c) > 127:
            raise self.error("non-ASCII characters in classes unsupported")
        return ord(c)

    def char_class(self) -> Frag:
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        mask = 0
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise self.error("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            save = self.pos
            if c == "\\":
                nxt = self.src[self.pos + 1: self.pos + 2]
                if nxt in _ESCAPE_CLASSES:
                    self.take()
                    self.take()
                    mask |= _ESCAPE_CLASSES[nxt]
                    first = False
                    continue
            lo = self._class_byte()
            if lo < 0:
                self.pos = save
                raise self.error("unsupported class member")
            if self.peek() == "-" and self.src[self.pos + 1: self.pos + 2] not in ("]", ""):
                self.take()
                hi = self._class_byte()
                if hi < 0 or hi < lo:
                    raise self.error("bad class range")
                mask |= mask_range(lo, hi)
            else:
                mask |= 1 << lo
            first = False
        if negate:
            # Complement matches any char NOT listed — including
            # non-ASCII, via the UTF-8 any-char automaton (still minus
            # the context-forbidden bytes).
            return self.b.utf8_char(exclude_ascii=(mask & _ASCII) | self.forbid)
        if not mask:
            raise self.error("empty character class")
        return self._cls(mask)


def regex_fragment(b: NfaBuilder, pattern: str, forbid: int = 0) -> Frag:
    """Compile ``pattern`` into an NFA fragment on ``b`` (fullmatch).

    ``forbid`` is a byte mask the surrounding context cannot represent
    (JSON-string contents forbid raw quote/backslash/controls): the
    compiled language is guaranteed disjoint from it, or compilation
    refuses."""
    p = _Parser(b, pattern, forbid=forbid)
    frag = p.expr()
    if p.pos != len(p.src):
        raise p.error("trailing characters (unbalanced ')'?)")
    return frag
