"""int8 KV cache (port of ``omnia_tpu/models/kv_quant.py``).

Rows are stored int8 with one float32 scale per (row, KV head): the
scale is ``max(absmax over D, 1e-8) / 127`` and the row rounds half to
even, clamped to ±127, so the port's int8 rows and scales are
bit-identical to the JAX package's (and to the numpy twins below).

A quantized cache is a :class:`QuantKV` (``q`` int8 ``[..., H, D]``,
``s`` f32 ``[..., H]``); the helpers take either a plain tensor or a
``QuantKV`` and dispatch with ``isinstance``. Attention applies the
scales to the score and probability matrices and never dequantizes the
cache as a whole (``ops/attention.py``, ``ops/decode_attention.py``).
Unlike the JAX package, writes are in place.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

KV_QUANT_MODES = ("int8",)

# Symmetric int8; the floor on the scale makes all-zero rows quantize to
# exact zeros instead of NaN.
_QMAX = 127.0
_EPS = 1e-8


def validate_kv_quant(mode: Optional[str]) -> Optional[str]:
    """None passes; anything but a known mode is refused."""
    if mode is None:
        return None
    if mode not in KV_QUANT_MODES:
        raise ValueError(
            f"unknown kv_quant mode {mode!r}; have {sorted(KV_QUANT_MODES)}"
        )
    return mode


class QuantKV:
    """One quantized KV tensor: int8 rows + per-(…, head) f32 scales."""

    __slots__ = ("q", "s")

    def __init__(self, q: Any, s: Any) -> None:
        self.q = q
        self.s = s

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return len(self.q.shape)

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes + self.s.nbytes)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"QuantKV(q={tuple(self.q.shape)}{self.q.dtype}, s={tuple(self.s.shape)})"


def is_quant_kv(x: Any) -> bool:
    return isinstance(x, QuantKV)


def as_quant_kv(x: Any) -> Any:
    """Another package's QuantKV (an object with ``q`` and ``s`` leaves,
    as the JAX package's) → this package's; anything else unchanged."""
    if not is_quant_kv(x) and hasattr(x, "q") and hasattr(x, "s"):
        return QuantKV(x.q, x.s)
    return x


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor) -> QuantKV:
    """x float [..., H, D] → QuantKV; the JAX package's ops in its order."""
    xf = x.float()
    # A true division by a device tensor: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, which can differ from the CPU's
    # (and the JAX package's) quotient in the last bit.
    qmax = torch.full((1,), _QMAX, dtype=torch.float32, device=xf.device)
    s = torch.clamp_min(xf.abs().amax(dim=-1), _EPS) / qmax
    q = torch.clamp(torch.round(xf / s[..., None]), -_QMAX, _QMAX).to(torch.int8)
    return QuantKV(q, s)


def dequantize_rows(kv: QuantKV, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """QuantKV → float rows (tests and host use; serving never does this)."""
    return (kv.q.float() * kv.s[..., None]).to(dtype)


def quantize_rows_np(x: np.ndarray) -> QuantKV:
    """Host (numpy) twin of :func:`quantize_rows`, bit for bit."""
    xf = np.asarray(x, np.float32)
    s = (np.maximum(np.max(np.abs(xf), axis=-1), _EPS) / _QMAX).astype(np.float32)
    q = np.clip(np.rint(xf / s[..., None]), -_QMAX, _QMAX).astype(np.int8)
    return QuantKV(q, s)


def dequantize_rows_np(kv: QuantKV) -> np.ndarray:
    return np.asarray(kv.q, np.float32) * np.asarray(kv.s, np.float32)[..., None]


# ---------------------------------------------------------------------------
# Cache-agnostic helpers (plain tensor OR QuantKV)
# ---------------------------------------------------------------------------


def kv_map(fn: Callable[..., Any], *caches: Any) -> Any:
    """Apply an op to both leaves of a QuantKV, or to the tensor itself.
    The op may touch only the leading axes (those before the head axis),
    which q and s share."""
    if is_quant_kv(caches[0]):
        return QuantKV(fn(*(c.q for c in caches)), fn(*(c.s for c in caches)))
    return fn(*caches)


def _window(shape: Sequence[int], starts: Sequence[int],
            sizes: Sequence[int]) -> tuple[slice, ...]:
    """Slices over the leading axes, each start clamped so its size fits
    (``dynamic_slice`` / ``dynamic_update_slice`` semantics)."""
    idx = []
    for axis, (start, n) in enumerate(zip(starts, sizes)):
        lo = min(max(int(start), 0), shape[axis] - n)
        idx.append(slice(lo, lo + n))
    return tuple(idx)


def _put(arr: torch.Tensor, chunk: torch.Tensor, starts: Sequence[int]) -> None:
    arr[_window(arr.shape, starts, chunk.shape)] = chunk.to(arr.dtype)


def cache_put(cache: Any, chunk: Any, starts: Sequence[int]) -> Any:
    """Write a chunk of rows into a cache in place at ``starts`` over the
    leading axes; returns the cache. A float chunk written into a
    QuantKV cache is quantized here; a QuantKV chunk moves verbatim."""
    if is_quant_kv(cache):
        if not is_quant_kv(chunk):
            chunk = quantize_rows(chunk)
        _put(cache.q, chunk.q, starts)
        _put(cache.s, chunk.s, starts)
        return cache
    if is_quant_kv(chunk):
        raise TypeError("quantized chunk written into an unquantized cache")
    _put(cache, chunk, starts)
    return cache


def cache_put_slot(cache: Any, chunk: Any, slot: torch.Tensor) -> Any:
    """``cache_put`` of a slot-row chunk ``[L, 1, T, ...]`` at rows [0, T)
    of the slot that the device index ``slot`` (int64 [1]) names, read on
    the device: a captured graph replays it for any slot. Same values as
    ``cache_put(cache, chunk, (0, slot, 0))``."""
    if is_quant_kv(cache) and not is_quant_kv(chunk):
        chunk = quantize_rows(chunk)
    kv_map(lambda a, c: a.narrow(2, 0, c.shape[2]).index_copy_(1, slot, c.to(a.dtype)),
           cache, chunk)
    return cache


def cache_take(cache: Any, starts: Sequence[int], lead_sizes: Sequence[int]) -> Any:
    """Rows of a cache over its leading axes (starts clamped as in
    ``dynamic_slice``; head/feature axes whole). A view of the cache,
    not a copy."""
    return kv_map(lambda a: a[_window(a.shape, starts, lead_sizes)], cache)


# ---------------------------------------------------------------------------
# Host paging
# ---------------------------------------------------------------------------


def _to_host(t: torch.Tensor) -> np.ndarray:
    # copy=True: rows of a CPU cache must not stay a view of it.
    if t.dtype == torch.bfloat16:
        # numpy has no bf16: the rows travel as their 16-bit patterns.
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy wants writable memory
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        # bf16 bit patterns: ours as np.uint16, the JAX package's as
        # ml_dtypes bfloat16; both reinterpret, never convert.
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(
            device).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def kv_host(cache: Any) -> Any:
    """Device rows → host numpy (a QuantKV of numpy leaves when
    quantized): the session offload format. bf16 rows become np.uint16."""
    return kv_map(_to_host, cache)


def kv_device(cache: Any, device) -> Any:
    """Host rows (:func:`kv_host`'s format, or the JAX package's, whose
    bf16 rows are ml_dtypes bfloat16) → tensors on ``device``."""
    return kv_map(lambda a: _to_device(a, device), cache)


def cache_bytes(*caches: Any) -> int:
    """Total bytes of the given caches (0 for None): tensors, QuantKV
    (scales included) or PagedKV (page table included), so capacity is
    measured against the real allocation."""
    return sum(int(c.nbytes) for c in caches if c is not None)
