"""Tokenizers for the serving engine (the port's own copy of
``omnia_tpu/engine/tokenizer.py``, without ``HFTokenizer``, which needs
``transformers``).

ByteTokenizer is the hermetic default: UTF-8 bytes + special tokens,
zero external files. IncrementalDetokenizer streams text deltas.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, then BOS/EOS/PAD."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class IncrementalDetokenizer:
    """Streams text deltas from a token stream.

    Decodes the active WINDOW of recent ids and emits the delta against
    the previous decode, so tokenizers whose per-token decode differs
    from in-context decode (sentencepiece leading-space markers, merge
    rules) stream exactly the text that decode(all_ids) would produce.
    A trailing replacement character is held back — it may be a UTF-8
    rune split across token boundaries.

    Windowed delta decode: once the window exceeds WINDOW tokens, its
    older half is folded out (dropped, with the emitted-char count
    rebased onto the remaining window's decode) — but ONLY at a split
    point where ``decode(left) + decode(right) == decode(window)``
    (checked literally, so any tokenizer quirk — a rune split across the
    cut, a sentencepiece merge — simply defers the fold one token rather
    than corrupting the stream). Per-push work is O(WINDOW) instead of
    O(generated tokens): the old full-sequence decode — and equally a
    fold that keeps concatenating an ever-growing text prefix — makes
    streaming quadratic on long generations.
    """

    WINDOW = 32

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []  # the active decode window
        self._emitted = 0  # chars of the window's decode already streamed

    def _shrink(self, text: str) -> None:
        # ``text`` is push()'s decode of the full window — reusing it
        # makes the split-safety check cost the two halves, not three
        # full-window decodes per emitted token.
        if len(self._ids) <= self.WINDOW:
            return
        cut = len(self._ids) - self.WINDOW // 2
        left, right = self._ids[:cut], self._ids[cut:]
        l_text = self._tok.decode(left)
        if l_text.endswith("�"):
            return  # split lands mid-rune: retry next push
        if l_text + self._tok.decode(right) != text:
            return  # tokenizer merges across the cut: retry next push
        # A fold only happens right after a successful delta emit, so
        # l_text is fully streamed — drop it and rebase the emitted
        # count onto the surviving window's decode.
        self._ids = right
        self._emitted -= len(l_text)

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        if text.endswith("�"):
            return ""
        delta = text[self._emitted:]
        self._emitted = len(text)
        self._shrink(text)
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._ids.clear()
        self._emitted = 0
        return delta
