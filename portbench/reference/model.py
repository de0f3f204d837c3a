"""The plain reference: a Mistral / Mixtral decoder in float32 PyTorch.

It follows the published architecture (Hugging Face ``MistralForCausalLM``
and ``MixtralForCausalLM``): RMSNorm, rotary embeddings of the
rotate-half form with ``inv_freq = theta ** (-2i / head_dim)``, grouped
query attention with a causal mask and ``1 / sqrt(head_dim)`` scaling,
a SwiGLU MLP, or for Mixtral a softmax router whose top-k experts are
renormalized to sum 1 and summed by those weights, with no capacity
limit and nothing dropped. No cache and no kernel: every sequence runs
whole and causal, layer by layer, and only the logits asked for are
made.

Weights come layer by layer from a function the caller gives (the
benchmark draws each layer again from the run's seed), in the served
dtype, projections ``[in, out]``; a layer is cast to float32 only while
it runs, so a model whose float32 copy would not fit the card still
runs. TF32 is off while the reference runs.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 (activations per row, weights per output column,
each scaled to the format's largest value) and multiplied in float32,
the W8A8 fp8 path that a later change might take for the model's
bfloat16. Attention, norms and the router stay float32.
``precision="bf16"`` is a witness of what rounding alone does: every
matrix product's operands and result, the router's among them, and the
residual stream are rounded to bfloat16, as a bfloat16 program holds
them.

``admitted_floor`` and ``sampler_probs`` give the set of tokens that a
sampler with a temperature, top-k and top-p admits (top-k first, then
the nucleus over the renormalized survivors, the Hugging Face
convention) and its probabilities.

This module imports torch only: nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 on the card while the block runs."""
    cuda_mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to the format's largest value),
    returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] in float32, or through fp8 operands."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, -2)
    elif precision == "bf16":
        return _round(_round(x, precision) @ _round(w, precision), precision)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as the bf16 witness holds it: rounded to bfloat16, in float32."""
    return x.bfloat16().float() if precision == "bf16" else x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D] at integer positions [T]: the rotate-half rotation."""
    D = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                            device=x.device) / D)
    ang = (positions.double()[:, None] * inv_freq[None]).float()
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA over one sequence: q [T, H, D], k, v [T, Hkv, D] → [T, H·D]."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hts,shd->thd", probs, v).reshape(T, H * D)


def dense_mlp(h: torch.Tensor, p: dict, precision: str) -> torch.Tensor:
    gate = matmul(h, p["wg"], precision)
    up = matmul(h, p["wu"], precision)
    return matmul(torch.nn.functional.silu(gate) * up, p["wd"], precision)


def moe_mlp(h: torch.Tensor, p: dict, top_k: int, precision: str) -> torch.Tensor:
    """Mixtral's sparse MLP: every token to its top-k experts, no capacity."""
    router = p["router"].float()
    logits = matmul(h, router, precision) if precision == "bf16" else h @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(p["router"].shape[-1]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        pe = {name: p[name][e] for name in ("wg", "wu", "wd")}
        y = dense_mlp(h[tok], pe, precision)
        out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(layer: Callable[[int], dict], top: dict, cfg: dict, sequences: list,
              wanted: list, precision: str = "f32", device=None) -> list:
    """float32 logits of each sequence at its wanted positions.

    ``layer(i)``: layer i's weights (``ln1``, ``ln2``, ``attn``, ``mlp``);
    ``top``: ``embed``, ``final_norm`` and ``lm_head``. ``sequences``:
    token id lists; ``wanted[j]``: positions of sequence j whose
    next-token logits are asked for. ``cfg`` is the configuration file's
    dict (Hugging Face keys). Returns one [len(wanted[j]), V] tensor per
    sequence. Runs layer-outer: each layer is fetched and cast once, and
    every product runs over all the sequences' rows."""
    device = device or top["embed"].device
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Hkv = cfg["num_key_value_heads"]
    Dh = cfg.get("head_dim") or D // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    experts = cfg.get("num_local_experts", 0)
    with no_tf32():
        lengths = [len(s) for s in sequences]
        ids = torch.tensor([t for s in sequences for t in s], device=device)
        pos = torch.cat([torch.arange(n, device=device) for n in lengths])
        x = _round(top["embed"][ids].float(), precision)   # every sequence's rows
        for i in range(cfg["num_hidden_layers"]):
            p = layer(i)
            h = rms_norm(x, p["ln1"], eps)
            q = rope(matmul(h, p["attn"]["wq"], precision).view(-1, H, Dh), pos, theta)
            k = rope(matmul(h, p["attn"]["wk"], precision).view(-1, Hkv, Dh), pos, theta)
            v = matmul(h, p["attn"]["wv"], precision).view(-1, Hkv, Dh)
            a = torch.cat([attention(qs, ks, vs) for qs, ks, vs in
                           zip(q.split(lengths), k.split(lengths), v.split(lengths))])
            x = _round(x + matmul(a, p["attn"]["wo"], precision), precision)
            h = rms_norm(x, p["ln2"], eps)
            if experts:
                x = x + moe_mlp(h, p["mlp"], cfg["num_experts_per_tok"], precision)
            else:
                x = x + dense_mlp(h, p["mlp"], precision)
            x = _round(x, precision)
        head = top["embed"].T if cfg.get("tie_word_embeddings") else top["lm_head"]
        out = []
        for xs, w in zip(x.split(lengths), wanted):
            h = rms_norm(xs[torch.tensor(w, device=device)], top["final_norm"], eps)
            out.append(matmul(h, head, precision))
        return out


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position, how far the chosen token's reference logit lies
    below the reference's best."""
    return ref_logits.amax(-1) - ref_logits.gather(-1, tokens.long()[:, None])[:, 0]



def admitted_floor(logits: torch.Tensor, temperature: float, top_p: float,
                   top_k: int) -> torch.Tensor:
    """Per position [N], the least temperature-scaled logit (logits / T)
    that the sampler admits: top-k first (k <= 0: off), then the smallest
    prefix of the survivors, by descending probability renormalized over
    them, whose mass before each member is under top_p (>= 1: off)."""
    s = logits.float() / temperature
    V = s.shape[-1]
    k = top_k if 0 < top_k < V else V
    top = torch.topk(s, k, dim=-1, sorted=True).values
    if top_p >= 1.0:
        return top[:, -1]
    e = torch.softmax(top, dim=-1)
    keep = (e.cumsum(-1) - e) < top_p
    return top.masked_fill(~keep, torch.inf).amin(-1)


def sampler_probs(logits: torch.Tensor, temperature: float, top_p: float,
                  top_k: int) -> torch.Tensor:
    """[N, V]: the probabilities with which that sampler draws each token."""
    s = logits.float() / temperature
    floor = admitted_floor(logits, temperature, top_p, top_k)
    return torch.softmax(s.masked_fill(s < floor[:, None], -torch.inf), dim=-1)
