"""Length-aware GQA decode attention (port of the unquantized edition of
``omnia_tpu/ops/decode_attention.py::decode_gqa_attention``).

On a CUDA tensor :func:`decode_gqa_attention` launches the hand-written
kernel in ``csrc/decode_attention.cu`` or raises; on a CPU tensor it
runs :func:`decode_gqa_attention_ref`, the plain PyTorch version of the
same function, which the tests also hold the kernel against. Neither
reads a cache row past ``positions[b]``.
"""

from __future__ import annotations

import ctypes

import torch

from omnia_tpu_torch import kernels

_NEG_INF = -1e30
# Rows per split of the flash-decoding partial pass.
SPLIT_ROWS = 64
HEAD_DIMS = (16, 64, 128)
GROUP_SIZES = (1, 2, 4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """Plain version. q [B, H, D] (rotary applied); k, v [B, S, Hkv, D];
    positions int [B] → [B, H, D] in q's dtype. f32 math; rows past each
    position are masked to -1e30 and zeroed before they are read, so
    whatever they hold (NaN included) cannot reach the output."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    valid = (torch.arange(S, device=q.device)[None, :]
             <= positions.to(torch.long)[:, None])           # [B, S]
    vmask = valid[:, :, None, None]
    kf = torch.where(vmask, k.float(), 0.0)
    vf = torch.where(vmask, v.float(), 0.0)
    qg = q.float().reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, kf) * (D ** -0.5)
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vf)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _lib():
    lib = kernels.load("decode_attention")
    fn = lib.omnia_decode_gqa_attention
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p, or ctypes cuts them to 32 bits.
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, positions):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B,H,D] and k, v [B,S,Hkv,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    Hkv = k.shape[2]
    if D not in HEAD_DIMS or H % Hkv or H // Hkv not in GROUP_SIZES:
        raise ValueError(
            f"unsupported head_dim {D} / group {H}/{Hkv}: kernel takes "
            f"D in {HEAD_DIMS} and G in {GROUP_SIZES}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: kernel takes one of "
            "float32, bfloat16 for q, k and v alike"
        )
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise ValueError(f"positions must be int32 [{B}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    devs = {q.device, k.device, v.device, positions.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    for name, t in (("q", q), ("k", k), ("v", v), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """q [B, H, D]; k, v [B, S, Hkv, D]; positions int32 [B] → [B, H, D].

    CUDA tensors go through the kernel (one call runs its partial and
    combine passes and counts one launch); CPU tensors through the plain
    version. Any S is taken: the kernel masks the ragged edge itself."""
    _check(q, k, v, positions)
    if q.device.type == "cpu":
        return decode_gqa_attention_ref(q, k, v, positions)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for device {q.device}")
    fn = _lib()
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    num_splits = -(-S // SPLIT_ROWS)
    out = torch.empty_like(q)
    part_m = torch.empty((B, Hkv, num_splits, G), device=q.device, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, num_splits, G, D), device=q.device,
                           dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
             out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
             part_acc.data_ptr(), B, S, H, Hkv, D, _DTYPE_CODES[q.dtype],
             SPLIT_ROWS, stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    decode_gqa_attention.launches += 1
    return out


decode_gqa_attention.launches = 0
