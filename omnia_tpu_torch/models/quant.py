"""int8 weights (port of ``omnia_tpu/models/quant.py``).

Two modes, both symmetric per output channel:

- ``int8`` (W8A16, weight-only): weights stored int8 with an f32 scale
  per output channel; the product runs on the int8 values cast to the
  activation dtype (exact: |q| <= 127), stays f32 until the scale is
  applied to the *output* (a per-output-channel scale commutes with the
  contraction: ``h @ (q * s) == (h @ q) * s``), then rounds once to the
  activation dtype, as the JAX package does. On the card the weight is
  cast per call and ``torch.mm(..., out_dtype=float32)`` keeps the sum
  in f32.
- ``int8-dynamic`` (W8A8): activations are quantized per token (row
  absmax) on the fly and the product is an exact int8 x int8 -> int32
  contraction (``torch._int_mm``), so the port's sums equal the JAX
  package's bit for bit; only the f32 rescale follows. The W8A8 weight is
  stored column-major (a transposed ``[..., N, K]`` buffer): cuBLASLt's
  int8 GEMM takes that layout ("TN") at every shape, and refuses a
  row-major one at some (K = 64 on the card's torch 2.11).

Quantized leaves are ``{"w8"|"w8d": int8 [..., K, N], "s": f32 [..., N]}``
dicts, the JAX package's format: the key encodes the mode, so ``qdot``
dispatches on the leaf and no flag is threaded through the forward.
Layer-stacked weights quantize per (layer, output channel). MoE experts
are not quantized.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

QUANT_MODES = ("int8", "int8-dynamic")

_MODE_KEY = {"int8": "w8", "int8-dynamic": "w8d"}
_QMAX = 127.0
_EPS = 1e-8
# Quantization works in column blocks of at most this many elements, so
# its f32 temporaries stay ~1 GB whatever the weight (lm_head at
# llama3-70b is 1.05 G elements). Output channels are independent, so
# the blocks give the same bits as one pass.
_BLOCK_ELEMENTS = 1 << 26
# torch._int_mm on CUDA takes only more than 16 rows.
_INT_MM_MIN_ROWS = 17


def _div_qmax(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as a true division on every device. CUDA divides by a
    Python scalar as a multiply by its reciprocal, which can differ from
    the CPU's (and the JAX package's) quotient in the last bit."""
    return x / torch.full((1,), _QMAX, dtype=x.dtype, device=x.device)


def with_product_layout(leaf: dict) -> dict:
    """A quantized leaf with its int8 values in the layout its product
    reads: a W8A8 weight column-major (strides ``(..., 1, K)``), a W8A16
    one as it is."""
    q = leaf.get("w8d")
    if q is not None and q.stride(-2) != 1:
        leaf = dict(leaf, w8d=q.transpose(-1, -2).contiguous().transpose(-1, -2))
    return leaf


def _key_for(mode: str) -> str:
    if mode not in _MODE_KEY:
        raise ValueError(f"unknown quant mode {mode!r}; have {sorted(_MODE_KEY)}")
    return _MODE_KEY[mode]


def is_quantized(w) -> bool:
    """True if ``w`` is a quantized-weight dict (either mode)."""
    return isinstance(w, dict) and ("w8" in w or "w8d" in w)


def params_quantized(params) -> bool:
    """True if the param tree already carries quantized matmul weights."""
    return is_quantized(params.get("layers", {}).get("attn", {}).get("wq"))


def detect_mode(params) -> Optional[str]:
    """The quant mode a pre-quantized tree was built with (None if dense)."""
    wq = params.get("layers", {}).get("attn", {}).get("wq")
    if not is_quantized(wq):
        return None
    return "int8" if "w8" in wq else "int8-dynamic"


def validate_mode(mode: Optional[str]) -> Optional[str]:
    """None passthrough + mode-string validation (EngineConfig surface)."""
    if mode is None:
        return None
    _key_for(mode)
    return mode


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------


def empty_weight(shape: tuple, mode: str, device) -> dict:
    """An unfilled quantized leaf for a weight of ``shape`` [..., K, N], its
    int8 values in the layout the mode's product reads."""
    shape = tuple(shape)
    if mode == "int8-dynamic":
        q = torch.empty(shape[:-2] + shape[:-3:-1], dtype=torch.int8,
                        device=device).transpose(-1, -2)
    else:
        q = torch.empty(shape, dtype=torch.int8, device=device)
    return {_key_for(mode): q,
            "s": torch.empty(shape[:-2] + shape[-1:], dtype=torch.float32, device=device)}


def quantize_into(leaf: dict, w: torch.Tensor, index=()) -> None:
    """Quantize ``w`` [..., K, N] (any device) into ``leaf[index]`` of a
    quantized leaf, on the leaf's device: scale = max(absmax over K,
    1e-8) / 127, round half to even, clamp to ±127 — the JAX package's
    ops in its order."""
    q = (leaf["w8"] if "w8" in leaf else leaf["w8d"])[index]
    s = leaf["s"][index]
    K, N = w.shape[-2:]
    step = max(1, _BLOCK_ELEMENTS // K)
    for lead in np.ndindex(*w.shape[:-2]):
        for j in range(0, N, step):
            wf = w[lead][:, j:j + step].to(q.device).float()
            sj = _div_qmax(torch.clamp_min(wf.abs().amax(dim=-2), _EPS))
            q[lead][:, j:j + step] = torch.clamp(torch.round(wf / sj), -_QMAX, _QMAX)
            s[lead][j:j + step] = sj


def quantize_weight(w: torch.Tensor, mode: str = "int8") -> dict:
    """w [..., K, N] → quantized dict on w's device; scales are per output
    channel N (absmax over the contraction axis K, symmetric)."""
    leaf = empty_weight(w.shape, mode, w.device)
    quantize_into(leaf, w)
    return leaf


def quantize_np(w: np.ndarray, mode: str = "int8") -> dict:
    """Host (numpy) twin of ``quantize_weight``, bit-identical to it."""
    key = _key_for(mode)
    wf = np.asarray(w, np.float32)
    s = (np.maximum(np.max(np.abs(wf), axis=-2), _EPS) / _QMAX).astype(np.float32)
    q = np.clip(np.rint(wf / s[..., None, :]), -_QMAX, _QMAX).astype(np.int8)
    return {key: q, "s": s}


def _map_quant_leaves(tree: dict, is_moe: bool, fn):
    """Apply ``fn`` to the matmul-weight leaves the int8 path covers:
    attention projections, dense-MLP projections, and lm_head. Embedding
    (gather, and tied-logits transpose), norms, and MoE routers/experts
    stay full precision."""
    out = dict(tree)
    layers = dict(tree["layers"])
    layers["attn"] = {k: fn(v) for k, v in tree["layers"]["attn"].items()}
    if not is_moe:
        layers["mlp"] = {k: fn(v) for k, v in tree["layers"]["mlp"].items()}
    out["layers"] = layers
    if "lm_head" in tree:
        out["lm_head"] = fn(tree["lm_head"])
    return out


def quantize_params(params, cfg, mode: str = "int8"):
    """Quantize a full-precision param tree (models/llama.py layout) on
    its device. Flagship checkpoints quantize in the loader instead
    (``models/checkpoint.py`` ``load_params(quant=...)``) or are born
    quantized (``init_params_quantized``)."""
    _key_for(mode)
    return _map_quant_leaves(params, cfg.is_moe, lambda w: quantize_weight(w, mode))


def init_params_quantized(cfg, generator: torch.Generator, device, mode: str = "int8",
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random params born quantized, on ``device`` (the generator's): each
    int8 leaf is drawn directly as int8, so no full-precision or int64
    copy of a stacked weight ever exists. Same structure as
    ``llama.init_params``; scales are set so the dequantized std matches
    its 0.02 (uniform int8 in [-127, 127] has std ≈ 127/√3). Same shapes
    and scales as the JAX package; not the same numbers."""
    if cfg.is_moe:
        raise ValueError("int8 quantization does not cover MoE experts")
    qkey = _key_for(mode)
    L, D, F, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(std)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def qleaf(shape, std=0.02):
        leaf = empty_weight(shape, mode, device)
        leaf[qkey].random_(-127, 128, generator=generator)
        leaf["s"].fill_(std * (3.0**0.5) / _QMAX)
        return leaf

    wo_std = 0.02 / (2 * L) ** 0.5
    params = {
        "embed": normal((V, D)),
        "layers": {
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
            "attn": {
                "wq": qleaf((L, D, cfg.q_dim)),
                "wk": qleaf((L, D, cfg.kv_dim)),
                "wv": qleaf((L, D, cfg.kv_dim)),
                "wo": qleaf((L, cfg.q_dim, D), std=wo_std),
            },
            "mlp": {
                "wg": qleaf((L, D, F)),
                "wu": qleaf((L, D, F)),
                "wd": qleaf((L, F, D), std=wo_std),
            },
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qleaf((D, V))
    return params


# ---------------------------------------------------------------------------
# Quantized matmul
# ---------------------------------------------------------------------------


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] → int32 [M, N] through
    ``torch._int_mm`` on either device. CUDA's takes only M > 16 rows (and
    K, N divisible by 8): fewer rows are padded with zero rows and the
    result sliced back."""
    M = a.shape[0]
    if M < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - M, a.shape[1])])
    return torch._int_mm(a, b)[:M]


def _w8a16_product(h: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """h [M, K] x int8 q [K, N] → f32 [M, N]. On the card, bf16 / f16
    activations meet the weight cast to their dtype (exact) and cuBLAS
    returns the f32 sums; elsewhere the product is computed in f32."""
    if h.device.type == "cuda" and h.dtype != torch.float32:
        return torch.mm(h, q.to(h.dtype), out_dtype=torch.float32)
    return torch.mm(h.float(), q.float())


def qdot(h: torch.Tensor, w) -> torch.Tensor:
    """``torch.matmul`` that accepts quantized-weight dicts transparently.

    h: [..., K] activations; w: [K, N] tensor or quantized dict. The
    forward calls this at every projection site, so swapping the param
    tree turns quantization on with no branching in the model code."""
    if not is_quantized(w):
        return torch.matmul(h, w)
    lead, s = h.shape[:-1], w["s"]
    h2 = h.reshape(-1, h.shape[-1])
    if "w8" in w:
        out = _w8a16_product(h2, w["w8"]) * s
    else:
        # W8A8: per-token absmax quantization of the activations, then an
        # exact int32 contraction; the scales apply in the JAX order.
        hf = h2.float()
        s_in = _div_qmax(torch.clamp_min(hf.abs().amax(dim=-1, keepdim=True), _EPS))
        hq = torch.clamp(torch.round(hf / s_in), -_QMAX, _QMAX).to(torch.int8)
        out = int8_matmul(hq, w["w8d"]).float() * s_in * s
    return out.to(h.dtype).reshape(*lead, out.shape[-1])
