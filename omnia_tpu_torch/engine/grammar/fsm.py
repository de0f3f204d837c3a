"""Byte-level NFA/DFA core for grammar-constrained decoding.

The compiler pipeline is: grammar source (JSON Schema / regex / tool-call
convention) → byte-level NFA fragments (Thompson construction over the
256-byte alphabet, UTF-8 aware where character semantics matter) → subset
construction → dead-state-pruned DFA → token-level transition table over
the engine tokenizer (:class:`TokenGrammar`).

Everything here is host-side (numpy only): importing this package
allocates no device memory. The engine owns the device copies of the
per-slot tables (engine.py).

Masking model (the Outlines/XGrammar insight): one dense
``[states, vocab]`` int32 table per grammar where entry ``(s, t)`` is
the successor state after emitting token ``t`` from state ``s``, or
``-1`` when ``t`` is disallowed. The decode step gathers row ``s`` and
adds ``-inf`` where the row is negative — validity becomes a property of
the sampler.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np


class GrammarError(ValueError):
    """Base error for grammar compilation/usage failures."""


class GrammarUnsupported(GrammarError):
    """The source grammar uses a feature the FSM compiler cannot enforce.

    Callers fall back to post-hoc validation — soundness contract: a
    grammar either compiles completely (every output the mask admits
    validates) or refuses to compile at all. There is no 'partially
    enforced' mode, because that is exactly the state where the post-hoc
    validator could still fire with the grammar attached.
    """


class GrammarTooLarge(GrammarError):
    """State budget exceeded (NFA/DFA construction or device table)."""


# Byte sets are 256-bit int bitmasks: bit b set ⇔ byte b is in the set.
def mask_of(data: bytes) -> int:
    m = 0
    for b in data:
        m |= 1 << b
    return m


def mask_range(lo: int, hi: int) -> int:
    """Inclusive byte range [lo, hi] as a bitmask."""
    return ((1 << (hi + 1)) - 1) ^ ((1 << lo) - 1)


class Frag:
    """A self-contained NFA fragment: every edge reachable from ``start``
    stays inside the fragment, and ``end`` has no outgoing edges at build
    time (Thompson discipline — what makes :meth:`NfaBuilder.clone`
    sound)."""

    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end


class NfaBuilder:
    """Thompson-construction builder over the byte alphabet."""

    MAX_STATES = 200_000  # runaway-repeat backstop

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[int, int]]] = []  # (byte mask, dst)

    def state(self) -> int:
        if len(self.eps) >= self.MAX_STATES:
            raise GrammarTooLarge(f"NFA exceeds {self.MAX_STATES} states")
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def link(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def edge(self, a: int, mask: int, b: int) -> None:
        if mask:
            self.edges[a].append((mask, b))

    # -- fragment combinators ------------------------------------------

    def epsilon(self) -> Frag:
        s = self.state()
        e = self.state()
        self.link(s, e)
        return Frag(s, e)

    def cls(self, mask: int) -> Frag:
        """One byte drawn from ``mask``."""
        s = self.state()
        e = self.state()
        self.edge(s, mask, e)
        return Frag(s, e)

    def lit(self, data: bytes) -> Frag:
        if not data:
            return self.epsilon()
        s = self.state()
        cur = s
        for b in data:
            nxt = self.state()
            self.edge(cur, 1 << b, nxt)
            cur = nxt
        return Frag(s, cur)

    def seq(self, *frags: Frag) -> Frag:
        frags = [f for f in frags if f is not None]
        if not frags:
            return self.epsilon()
        for a, b in zip(frags, frags[1:]):
            self.link(a.end, b.start)
        return Frag(frags[0].start, frags[-1].end)

    def alt(self, *frags: Frag) -> Frag:
        frags = [f for f in frags if f is not None]
        if not frags:
            raise GrammarError("alt() of zero fragments")
        if len(frags) == 1:
            return frags[0]
        s = self.state()
        e = self.state()
        for f in frags:
            self.link(s, f.start)
            self.link(f.end, e)
        return Frag(s, e)

    def opt(self, f: Frag) -> Frag:
        s = self.state()
        e = self.state()
        self.link(s, f.start)
        self.link(f.end, e)
        self.link(s, e)
        return Frag(s, e)

    def star(self, f: Frag) -> Frag:
        s = self.state()
        e = self.state()
        self.link(s, f.start)
        self.link(f.end, e)
        self.link(f.end, f.start)
        self.link(s, e)
        return Frag(s, e)

    def plus(self, f: Frag) -> Frag:
        s = self.state()
        e = self.state()
        self.link(s, f.start)
        self.link(f.end, e)
        self.link(f.end, f.start)
        return Frag(s, e)

    def clone(self, f: Frag) -> Frag:
        """Deep-copy a fragment (Thompson discipline keeps it closed)."""
        mapping: dict[int, int] = {}
        stack = [f.start, f.end]
        while stack:
            st = stack.pop()
            if st in mapping:
                continue
            mapping[st] = self.state()
            for dst in self.eps[st]:
                if dst not in mapping:
                    stack.append(dst)
            for _m, dst in self.edges[st]:
                if dst not in mapping:
                    stack.append(dst)
        for src, new_src in mapping.items():
            for dst in self.eps[src]:
                self.link(new_src, mapping[dst])
            for m, dst in self.edges[src]:
                self.edge(new_src, m, mapping[dst])
        return Frag(mapping[f.start], mapping[f.end])

    MAX_REPEAT = 256

    def repeat(self, f: Frag, lo: int, hi: Optional[int]) -> Frag:
        """``f{lo,hi}`` (hi=None ⇒ unbounded). Bounded counts expand to
        clones — the state cost is why :data:`MAX_REPEAT` caps them."""
        if lo < 0 or (hi is not None and (hi < lo or hi > self.MAX_REPEAT)) \
                or lo > self.MAX_REPEAT:
            raise GrammarTooLarge(f"repeat bounds {{{lo},{hi}}} out of range")
        parts = [self.clone(f) for _ in range(lo)]
        if hi is None:
            parts.append(self.star(self.clone(f)))
        else:
            # {0,k} as nested options so partial runs still reach the end.
            tail: Optional[Frag] = None
            for _ in range(hi - lo):
                inner = self.clone(f)
                tail = self.opt(inner if tail is None else self.seq(inner, tail))
            if tail is not None:
                parts.append(tail)
        if not parts:
            return self.epsilon()
        return self.seq(*parts)

    def utf8_char(self, exclude_ascii: int = 0) -> Frag:
        """One well-formed UTF-8 encoded codepoint, excluding the ASCII
        bytes in ``exclude_ascii`` (multi-byte sequences are never
        excluded — exclusions are ASCII-only by contract)."""
        ascii_mask = mask_range(0x00, 0x7F) & ~exclude_ascii
        branches = []
        if ascii_mask:
            branches.append(self.cls(ascii_mask))
        cont = mask_range(0x80, 0xBF)
        # Well-formed UTF-8 ONLY (RFC 3629 table): over-long encodings
        # and surrogates are excluded, so one automaton char decodes to
        # exactly one output character — string length bounds in schemas
        # count characters, and a sloppy byte automaton here would let a
        # 3-byte invalid sequence decode into three replacement chars.
        branches.append(self.seq(self.cls(mask_range(0xC2, 0xDF)), self.cls(cont)))
        branches.append(self.seq(
            self.cls(1 << 0xE0), self.cls(mask_range(0xA0, 0xBF)), self.cls(cont)))
        branches.append(self.seq(
            self.cls(mask_range(0xE1, 0xEC) | (1 << 0xEE) | (1 << 0xEF)),
            self.cls(cont), self.cls(cont)))
        branches.append(self.seq(
            self.cls(1 << 0xED), self.cls(mask_range(0x80, 0x9F)), self.cls(cont)))
        branches.append(self.seq(
            self.cls(1 << 0xF0), self.cls(mask_range(0x90, 0xBF)),
            self.cls(cont), self.cls(cont)))
        branches.append(self.seq(
            self.cls(mask_range(0xF1, 0xF3)), self.cls(cont), self.cls(cont),
            self.cls(cont)))
        branches.append(self.seq(
            self.cls(1 << 0xF4), self.cls(mask_range(0x80, 0x8F)),
            self.cls(cont), self.cls(cont)))
        return self.alt(*branches)


class Dfa:
    """Dense byte-level DFA: ``trans[s, b]`` = successor or -1."""

    __slots__ = ("trans", "accept", "start")

    def __init__(self, trans: np.ndarray, accept: np.ndarray, start: int):
        self.trans = trans
        self.accept = accept
        self.start = start

    @property
    def num_states(self) -> int:
        return int(self.trans.shape[0])

    def next(self, state: int, byte: int) -> int:
        return int(self.trans[state, byte])


def determinize(b: NfaBuilder, start: int, accepts: set[int],
                max_states: int = 8192) -> Dfa:
    """Subset construction + dead-state pruning.

    Pruning removes states that cannot reach an accepting state, so every
    surviving transition leads somewhere completable — the mask can never
    steer generation into a dead end (the invariant the engine's
    all-masked-row placement check relies on).
    """
    n = len(b.eps)
    closure_memo: dict[int, frozenset[int]] = {}

    def closure(states) -> frozenset[int]:
        out: set[int] = set()
        stack = list(states)
        while stack:
            s = stack.pop()
            if s in out:
                continue
            cached = closure_memo.get(s)
            if cached is not None:
                out |= cached
                continue
            out.add(s)
            stack.extend(b.eps[s])
        return frozenset(out)

    for s in range(n):
        closure_memo[s] = closure([s])

    start_set = closure([start])
    index: dict[frozenset[int], int] = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # Group outgoing edges by mask so the 256-byte sweep walks masks,
        # not (state × edge) pairs.
        by_mask: dict[int, set[int]] = {}
        for s in cur:
            for m, dst in b.edges[s]:
                by_mask.setdefault(m, set()).add(dst)
        masks = list(by_mask.items())
        row = np.full(256, -1, np.int32)
        combo_memo: dict[tuple, int] = {}
        for byte in range(256):
            bit = 1 << byte
            combo = tuple(j for j, (m, _t) in enumerate(masks) if m & bit)
            if not combo:
                continue
            tgt = combo_memo.get(combo)
            if tgt is None:
                tset: set[int] = set()
                for j in combo:
                    tset |= masks[j][1]
                key = closure(tset)
                tgt = index.get(key)
                if tgt is None:
                    if len(order) >= max_states:
                        raise GrammarTooLarge(
                            f"DFA exceeds {max_states} states")
                    tgt = len(order)
                    index[key] = tgt
                    order.append(key)
                combo_memo[combo] = tgt
            row[byte] = tgt
        rows.append(row)

    trans = np.stack(rows) if rows else np.full((1, 256), -1, np.int32)
    accept_arr = np.array(
        [bool(st & accepts) for st in order], dtype=bool
    ) if order else np.array([False])

    # Prune states that cannot reach accept (reverse BFS).
    S = trans.shape[0]
    live = accept_arr.copy()
    changed = True
    while changed:
        changed = False
        # A state is live if any transition lands on a live state.
        step = np.zeros(S, bool)
        valid = trans >= 0
        tgt = np.where(valid, trans, 0)
        step = (valid & live[tgt]).any(axis=1)
        new_live = live | step
        if (new_live != live).any():
            live = new_live
            changed = True
    if not live[0]:
        raise GrammarError("grammar matches no strings (start state dead)")
    remap = np.full(S, -1, np.int32)
    remap[live] = np.arange(int(live.sum()), dtype=np.int32)
    trans = trans[live]
    trans = np.where(trans >= 0, remap[np.where(trans >= 0, trans, 0)], -1)
    trans = trans.astype(np.int32)
    return Dfa(trans, accept_arr[live], int(remap[0]))


# ---------------------------------------------------------------------------
# Token-level compilation
# ---------------------------------------------------------------------------


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode: the printable-surrogate
    alphabet byte-level BPE vocabularies are written in."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_FALLBACK = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _piece_bytes(piece: str, byte_level: bool,
                 gpt2_dec: dict[str, int]) -> Optional[bytes]:
    """Exact byte string of one vocab piece. byte-level BPE pieces map
    char-by-char through the GPT-2 byte alphabet (approximating them by
    re-encoding UTF-8 would shift every non-ASCII byte — e.g. 'Ã©'
    (é, C3 A9) would become C3 83 C2 A9 and the token table would mask
    the wrong tokens); sentencepiece ``<0xNN>`` byte-fallback pieces ARE
    single bytes; other sentencepiece pieces swap the ▁ word marker for
    a space. Unmappable pieces return None (the token stays masked —
    refusing one token is sound, emitting wrong bytes is not)."""
    m = _BYTE_FALLBACK.match(piece)
    if m:
        return bytes([int(m.group(1), 16)])
    if byte_level:
        out = bytearray()
        for ch in piece:
            b = gpt2_dec.get(ch)
            if b is None:
                return None
            out.append(b)
        return bytes(out)
    return piece.replace("▁", " ").encode("utf-8")


def tokenizer_token_bytes(tokenizer) -> list[Optional[bytes]]:
    """Byte string each token id contributes to the output, or None for
    specials/unmappable ids (None ⇒ permanently masked).

    ByteTokenizer is byte-native (ids 0..255 ARE bytes). Other tokenizers
    go through the generic longest-match path: the full byte string of
    each token is walked through the DFA, so a multi-byte token is
    admitted only when every byte of it stays on a live path. A tokenizer
    may expose ``token_bytes()`` to provide exact byte strings; HF
    vocabularies derive them from the piece alphabet (GPT-2 byte-level
    decoder / sentencepiece markers + byte fallback).
    """
    hook = getattr(tokenizer, "token_bytes", None)
    if callable(hook):
        return list(hook())
    if getattr(tokenizer, "vocab_size", 0) == 259 and \
            getattr(tokenizer, "bos_id", None) == 256:
        return [bytes([i]) for i in range(256)] + [None, None, None]
    inner = getattr(tokenizer, "_tok", None)
    conv = getattr(inner, "convert_ids_to_tokens", None)
    pieces: list[Optional[str]] = []
    for i in range(tokenizer.vocab_size):
        try:
            if conv is not None:
                pieces.append(conv(i))
            else:
                pieces.append(tokenizer.decode([i]))
        except Exception:  # noqa: BLE001 - unmappable id ⇒ masked
            pieces.append(None)
    # Byte-level BPE vocabularies write a space as 'Ġ' (and newline as
    # 'Ċ') — their presence anywhere identifies the piece alphabet.
    byte_level = any(p and ("Ġ" in p or "Ċ" in p) for p in pieces)
    gpt2_dec = _gpt2_byte_decoder() if byte_level else {}
    out: list[Optional[bytes]] = []
    for p in pieces:
        if not p:
            out.append(None)
            continue
        try:
            out.append(_piece_bytes(p, byte_level, gpt2_dec))
        except Exception:  # noqa: BLE001 - unmappable piece ⇒ masked
            out.append(None)
    return out


class SamplerView:
    """One grammar's token transition table materialized for a concrete
    (vocab_size, stop_ids) pair — the thing a sampler masks with.

    ``table[s, t]`` = successor state (or -1 = masked). Stop/EOS ids are
    unmasked ONLY in accepting states (self-transition), which is how
    "the output is complete" becomes a sampleable event and nothing
    else."""

    __slots__ = ("table", "accepting", "start", "masked_frac", "_dist",
                 "_completion")

    def __init__(self, table: np.ndarray, accepting: np.ndarray, start: int):
        self.table = table
        self.accepting = accepting
        self.start = start
        self.masked_frac = (table < 0).mean(axis=1).astype(np.float32)
        self._dist: Optional[np.ndarray] = None
        self._completion: Optional[np.ndarray] = None

    @property
    def num_states(self) -> int:
        return int(self.table.shape[0])

    def allowed(self, state: int) -> np.ndarray:
        return self.table[state] >= 0

    def advance(self, state: int, token: int) -> int:
        if token >= self.table.shape[1] or token < 0:
            return -1
        return int(self.table[state, token])

    def is_accepting(self, state: int) -> bool:
        return bool(self.accepting[state])

    def masked_fraction(self, state: int) -> float:
        return float(self.masked_frac[state])

    def _distances(self) -> np.ndarray:
        """Token-steps from each state to the nearest accepting state."""
        if self._dist is not None:
            return self._dist
        S = self.num_states
        INF = np.int32(1 << 30)
        dist = np.where(self.accepting, 0, INF).astype(np.int32)
        valid = self.table >= 0
        tgt = np.where(valid, self.table, 0)
        for _ in range(S + 1):
            via = np.where(valid, dist[tgt], INF).min(axis=1)
            new = np.minimum(dist, via + 1)
            if (new == dist).all():
                break
            dist = new
        self._dist = dist
        return dist

    def completion_token(self, state: int) -> int:
        """An allowed token that strictly decreases distance-to-accept —
        the deterministic 'finish the output' move (mock playback and
        worst-case walkers use it). -1 when the state is accepting."""
        if self.accepting[state]:
            return -1
        if self._completion is None:
            dist = self._distances()
            valid = self.table >= 0
            tgt = np.where(valid, self.table, 0)
            via = np.where(valid, dist[tgt], np.int32(1 << 30))
            self._completion = np.where(
                via.min(axis=1) < (1 << 30), via.argmin(axis=1), -1
            ).astype(np.int32)
        return int(self._completion[state])

    def check_live(self) -> None:
        """Every state must offer at least one token (or be accepting
        with a stop id unmasked) — otherwise sampling from it would see
        an all--inf row and degenerate to argmax-of-garbage."""
        rows = (self.table >= 0).any(axis=1)
        if not rows.all():
            bad = int(np.argmin(rows))
            raise GrammarError(
                f"state {bad} has no admissible token for this vocab "
                "(stop/eos id outside the model vocabulary, or a stop id "
                "that is also a required grammar token?)"
            )


class TokenGrammar:
    """A compiled grammar over one tokenizer: byte DFA + token table.

    ``view(vocab_size, stop_ids)`` materializes the sampler table for a
    concrete logits width (the MODEL vocabulary, which may exceed the
    tokenizer's) and the request's stop ids; views are memoized — the
    engine, the mock, and the host-side metrics mirror all read the same
    arrays. The memos are bounded LRU by entry count AND by bytes
    (``_MEMO_CAP`` / ``_MEMO_MAX_BYTES``): each entry is
    O(states × vocab) int32 — half a GB at 4096 states × a 128k HF
    vocab — and a caller varying per-request stop ids against one
    long-lived cached grammar must not grow host memory without bound.
    """

    _MEMO_CAP = 8
    _MEMO_MAX_BYTES = 256 << 20

    def __init__(self, dfa: Dfa, tokenizer, key: str = ""):
        self.dfa = dfa
        self.key = key
        self.eos_id = int(getattr(tokenizer, "eos_id", 0))
        self.vocab_size = int(tokenizer.vocab_size)
        token_bytes = tokenizer_token_bytes(tokenizer)
        S = dfa.num_states
        V = self.vocab_size
        table = np.full((S, V), -1, np.int32)
        states = np.arange(S, dtype=np.int32)
        for tid, data in enumerate(token_bytes):
            if not data:
                continue
            cur = states
            for byte in data:
                step = dfa.trans[np.where(cur >= 0, cur, 0), byte]
                cur = np.where(cur >= 0, step, -1).astype(np.int32)
            table[:, tid] = cur
        self._token_table = table
        # Guards the memos: a cached TokenGrammar is shared across
        # engines AND across each engine's submit/scheduler threads.
        self._memo_lock = threading.Lock()
        self._views: "OrderedDict[tuple, SamplerView]" = OrderedDict()
        self._device_tables: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    @property
    def num_states(self) -> int:
        return self.dfa.num_states

    def view(self, vocab_size: Optional[int] = None,
             stop_ids: Sequence[int] = ()) -> SamplerView:
        V = int(vocab_size or self.vocab_size)
        stops = tuple(sorted({self.eos_id, *stop_ids}))
        memo_key = (V, stops)
        with self._memo_lock:
            cached = self._views.get(memo_key)
            if cached is not None:
                self._views.move_to_end(memo_key)
                return cached
        S = self.num_states
        table = np.full((S, V), -1, np.int32)
        W = min(V, self.vocab_size)
        table[:, :W] = self._token_table[:, :W]
        acc = np.flatnonzero(self.dfa.accept)
        nonacc = np.flatnonzero(~self.dfa.accept)
        for sid in stops:
            if 0 <= sid < V:
                # Stop ids are admissible ONLY in accepting states. A
                # stop id that is also a grammar token (a '}' byte, a
                # newline token inside a pattern) must be masked
                # mid-grammar: the engine terminates on it, so sampling
                # it there would truncate to schema-invalid output. If
                # that starves a state outright, check_live refuses the
                # request up front instead.
                table[nonacc, sid] = -1
                table[acc, sid] = acc
        view = SamplerView(table, self.dfa.accept.copy(), self.dfa.start)
        with self._memo_lock:
            self._views[memo_key] = view
            self._evict(self._views, lambda v: v.table.nbytes)
        return view

    def validate(self, max_states: int, vocab_size: int,
                 stop_ids: Sequence[int] = ()) -> SamplerView:
        """Submit-time budget + liveness check on the exact ``[S, vocab]``
        view placement will upload — WITHOUT materializing the padded
        ``[max_states, vocab]`` table (at a 128k vocab that padding is
        gigabytes of host memory the check never reads)."""
        view = self.view(vocab_size, stop_ids)
        if view.num_states > max_states:
            raise GrammarTooLarge(
                f"grammar needs {view.num_states} states, engine "
                f"grammar_max_states is {max_states}"
            )
        view.check_live()
        return view

    def device_table(self, max_states: int, vocab_size: int,
                     stop_ids: Sequence[int] = ()) -> np.ndarray:
        """Padded ``[max_states, vocab]`` int32 table (memoized). The
        engine uploads the unpadded view directly into the slot rows —
        this full materialization is for callers that need the whole
        device-shaped array (bench arming, table-parity tests)."""
        stops = tuple(sorted(set(stop_ids)))
        memo_key = (max_states, vocab_size, stops)
        with self._memo_lock:
            cached = self._device_tables.get(memo_key)
            if cached is not None:
                self._device_tables.move_to_end(memo_key)
                return cached
        view = self.validate(max_states, vocab_size, stops)
        out = np.full((max_states, vocab_size), -1, np.int32)
        out[:view.num_states] = view.table
        with self._memo_lock:
            self._device_tables[memo_key] = out
            self._evict(self._device_tables, lambda a: a.nbytes)
        return out

    def _evict(self, memo: OrderedDict, size_of) -> None:
        """LRU-evict past the entry cap or the byte cap (the newest
        entry always survives — callers hold a reference to it)."""
        while len(memo) > self._MEMO_CAP or (
            len(memo) > 1
            and sum(size_of(v) for v in memo.values()) > self._MEMO_MAX_BYTES
        ):
            memo.popitem(last=False)

    def nbytes(self) -> int:
        """Host-memory footprint (token table + memoized views/tables),
        for byte-aware eviction in the process-global compile cache."""
        with self._memo_lock:
            return (
                self._token_table.nbytes
                + sum(v.table.nbytes for v in self._views.values())
                + sum(a.nbytes for a in self._device_tables.values())
            )


def walk_text(view: SamplerView, tokens: Sequence[int]) -> bool:
    """Test helper: does a token sequence stay on live states?"""
    s = view.start
    for t in tokens:
        s = view.advance(s, t)
        if s < 0:
            return False
    return True


def force_complete(
    view: SamplerView,
    propose: Callable[[int, np.ndarray], Optional[int]],
    max_tokens: int,
) -> tuple[list[int], bool]:
    """Constrained playback: at each step ask ``propose(state, allowed)``
    for a token; a disallowed/None proposal falls back to the completion
    move. Returns (tokens, completed). Shared by the mock engine and the
    worst-case property tests so both exercise the same mask semantics
    as the compiled decode path."""
    out: list[int] = []
    s = view.start
    for _ in range(max_tokens):
        allowed = view.allowed(s)
        cand = propose(s, allowed)
        if cand is None or cand >= allowed.shape[0] or not allowed[cand]:
            cand = view.completion_token(s)
            if cand < 0:
                # -1 means accepting (done) OR starved with no path to
                # accept — report which, don't assume the happy case.
                return out, view.is_accepting(s)
        nxt = view.advance(s, cand)
        if nxt < 0:  # completion from a live table can't miss, but be safe
            return out, view.is_accepting(s)
        out.append(cand)
        s = nxt
    return out, view.is_accepting(s)
