"""Length-aware GQA decode attention (port of the four editions of
``omnia_tpu/ops/decode_attention.py``).

- :func:`decode_gqa_attention` over a slot-contiguous cache: K1, or K2
  when the rows are int8 with ``k_scale``/``v_scale``;
- :func:`decode_gqa_attention_paged` over a page pool and a page table:
  K3, or K4 with scales.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/<edition>.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version of the same function, which the tests also hold the
kernel against. No version reads a cache row past ``positions[b]``, and
the paged ones read no table entry past ``positions[b] // PAGE_S``.

The kernels have no backward: on the card a wrapper raises when grad
mode is on and q, k or v requires grad, where a silent launch would cut
the gradient (the plain versions on the CPU are differentiable).

Launch counts: a wrapper adds one to ``LAUNCHES`` where it launches. A
call under CUDA-graph capture launches nothing then, and a replay runs
no Python, so a captured launch counts itself on the card instead (one
block adds one to a per-device count), and :func:`launches` sums both.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from omnia_tpu_torch import kernels
from omnia_tpu_torch.models.paged_kv import PagedKV, gather_view

_NEG_INF = -1e30
# Rows per split of the contiguous editions (the paged editions split by
# page), and the most rows one kernel block stages (kTileRows in
# csrc/decode_attention.cuh): a longer page is several tiles.
SPLIT_ROWS = 64
HEAD_DIMS = (16, 64, 128)
GROUP_SIZES = (1, 2, 4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel edition → the C function its source under csrc/ exports.
EDITIONS = {
    "decode_attention": "omnia_decode_gqa_attention",                   # K1
    "decode_attention_int8": "omnia_decode_gqa_attention_int8",         # K2
    "decode_attention_paged": "omnia_decode_gqa_attention_paged",       # K3
    "decode_attention_paged_int8": "omnia_decode_gqa_attention_paged_int8",  # K4
}
# Launches of each edition's kernel that its wrapper made (a call under
# CUDA-graph capture launches nothing, so it adds nothing).
LAUNCHES = dict.fromkeys(EDITIONS, 0)
# Device index → int32 [len(EDITIONS)]: launches from captured graphs, each
# counted on the card by the launch itself. Made with the device's first
# scratch buffer and never replaced, as the graphs keep its address.
_GRAPH_LAUNCHES: dict[int, torch.Tensor] = {}
# Device index → (int32 scratch buffer, counter capacity); see _scratch.
_SCRATCH: dict[int, tuple[torch.Tensor, int]] = {}
_SCRATCH_LOCK = threading.Lock()


def edition(quantized: bool, paged: bool) -> str:
    return "decode_attention" + ("_paged" if paged else "") + ("_int8" if quantized else "")


def launches() -> dict[str, int]:
    """Each edition's launches since :func:`reset_launches`: its wrapper's
    count plus the launches its kernel counted on the card from captured
    graphs (waits for each device's work)."""
    out = dict(LAUNCHES)
    for index, counts in _GRAPH_LAUNCHES.items():
        torch.cuda.synchronize(index)
        for name, n in zip(EDITIONS, counts.tolist()):
            out[name] += n
    return out


def reset_launches() -> None:
    """Set every launch count to 0, on the host and on each card."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in _GRAPH_LAUNCHES.values():
        counts.zero_()


def scratch_buffer(device: torch.device) -> Optional[torch.Tensor]:
    """The device's current scratch buffer, which a launch captured now
    points at: a graph's owner keeps it alive while the graph lives."""
    with _SCRATCH_LOCK:
        return _SCRATCH.get(device.index, (None, 0))[0]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _attend(q, k, v, positions, k_scale=None, v_scale=None):
    """The plain math of every edition over contiguous rows: f32, rows
    past each position masked to -1e30 and zeroed (scales too) before
    they are read, so whatever they hold (NaN included) cannot reach the
    output. With scales, the score is (q.k * D^-0.5) * k_scale and the pv
    term (p * v_scale) . v, while l sums the unscaled p."""
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
    if k_scale is not None:
        ks = torch.where(valid[:, :, None], k_scale.float(), 0.0)
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pv_p = p
    if v_scale is not None:
        vs = torch.where(valid[:, :, None], v_scale.float(), 0.0)
        pv_p = p * vs.permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bhgs,bshd->bhgd", pv_p, vf)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def decode_gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """K1's plain version. q [B, H, D] (rotary applied); k, v [B, S, Hkv,
    D] in q's dtype; positions int [B] → [B, H, D] in q's dtype."""
    return _attend(q, k, v, positions)


def decode_gqa_attention_quant_ref(q, k, v, k_scale, v_scale, positions):
    """K2's plain version: k, v int8 [B, S, Hkv, D] with f32 row scales
    [B, S, Hkv]."""
    return _attend(q, k, v, positions, k_scale, v_scale)


def decode_gqa_attention_paged_ref(q, pool_k, pool_v, table, positions,
                                   k_scale=None, v_scale=None):
    """K3's (K4's with scales) plain version: the slot-contiguous view
    through the table (``gather_view``), then the contiguous math."""
    k, v = (gather_view(PagedKV(p, table)) for p in (pool_k, pool_v))
    ks = vs = None
    if k_scale is not None:
        ks, vs = (gather_view(PagedKV(s, table)) for s in (k_scale, v_scale))
    return _attend(q, k, v, positions, ks, vs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib(name: str = "decode_attention"):
    """The C entry point of one edition, built at first use."""
    fn = getattr(kernels.load(name), EDITIONS[name])
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p, or ctypes cuts them to 32 bits.
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, positions, k_scale=None, v_scale=None, table=None):
    """Validate what every edition's kernel takes: q [B, H, D]; k, v rows
    [N, R, Hkv, D] (slots or pages); scales [N, R, Hkv]; table [B, NP]."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B,H,D] and k, v [N,R,Hkv,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, D = q.shape
    if (table is None and k.shape[0] != B) or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    Hkv = k.shape[2]
    if D not in HEAD_DIMS or H % Hkv or H // Hkv not in GROUP_SIZES:
        raise ValueError(
            f"unsupported head_dim {D} / group {H}/{Hkv}: kernel takes "
            f"D in {HEAD_DIMS} and G in {GROUP_SIZES}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    row_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in _DTYPE_CODES or k.dtype != row_dtype or v.dtype != row_dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: kernel takes q in float32 "
            f"or bfloat16 and k, v in {row_dtype}"
        )
    tensors = {"q": q, "k": k, "v": v, "positions": positions}
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3]:
                raise ValueError(f"{name} must be float32 {tuple(k.shape[:3])}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
            tensors[name] = s
    if table is not None:
        if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != B:
            raise ValueError(f"table must be int32 [{B}, NP], got "
                             f"{table.dtype} {tuple(table.shape)}")
        tensors["table"] = table
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise ValueError(f"positions must be int32 [{B}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scratch(device: torch.device, n_counters: int, n_partials: int):
    """Pointers to the combine counters ([n_counters] int32) and the
    partials ([n_partials] f32) of one launch, in one buffer kept per
    device: [counters | partials]. The counters are zeroed once, when the
    buffer is made, and every launch leaves them at 0; the buffer grows
    and never shrinks. Launches on one device share it, so they must be
    ordered on one stream, as the engine's are (a captured graph's
    replays included).

    A launch under CUDA-graph capture bakes the buffer's address into the
    graph, whose owner keeps the buffer (``scratch_buffer``) when the
    scratch grows later. The scratch cannot grow during a capture (the
    zeroing would be captured and the buffer would live in the graph's
    pool), so the capturer launches at its largest shape eagerly first.
    The device's graph launch counts are made with its first buffer."""
    capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    with _SCRATCH_LOCK:
        buf, cap = _SCRATCH.get(device.index, (None, 0))
        room = 0 if buf is None else buf.numel() - cap
        if n_counters > cap or n_partials > room:
            if capturing:
                raise RuntimeError(
                    "decode-attention scratch must grow during a CUDA-graph capture: "
                    "launch the captured shape once before capturing")
            # Partials start on a 256-byte boundary (the kernel reads float4s).
            cap, room = -(-max(cap, n_counters) // 64) * 64, max(room, n_partials)
            buf = torch.zeros(cap + room, dtype=torch.int32, device=device)
            _SCRATCH[device.index] = (buf, cap)
            if device.type == "cuda" and device.index not in _GRAPH_LAUNCHES:
                _GRAPH_LAUNCHES[device.index] = torch.zeros(len(EDITIONS), dtype=torch.int32,
                                                            device=device)
    return buf.data_ptr(), buf.data_ptr() + 4 * cap


def _launch(name, q, k, v, k_scale, v_scale, table, positions, S, split_rows):
    """Run one edition's kernel (partials and combine in one launch);
    counts one launch: here, or under capture on the card at each replay."""
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("the decode-attention kernel has no backward: run it under "
                         "torch.no_grad(), or keep q, k and v out of autograd")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary "
                         "(the kernel reads them 16 bytes at a time)")
    fn = _lib(name)
    B, H, D = q.shape
    Hkv = k.shape[2]
    tiles = -(-S // split_rows) * -(-split_rows // SPLIT_ROWS)
    counters, partials = _scratch(q.device, B * Hkv, B * H * tiles * (D + 2))
    capturing = torch.cuda.is_current_stream_capturing()
    count = None
    if capturing:
        count = _GRAPH_LAUNCHES[q.device.index][list(EDITIONS).index(name)].data_ptr()
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
             ptr(table), positions.data_ptr(), out.data_ptr(), counters, partials, count,
             B, S, H, Hkv, D, _DTYPE_CODES[q.dtype], split_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if not capturing:
        LAUNCHES[name] += 1
    return out


def decode_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, D]; k, v [B, S, Hkv, D]; positions int32 [B] → [B, H, D].
    With f32 ``k_scale``/``v_scale`` [B, S, Hkv] the rows are int8 (K2),
    else in q's dtype (K1). Any S is taken: the kernel masks the ragged
    edge itself."""
    _check(q, k, v, positions, k_scale, v_scale)
    if q.device.type == "cpu":
        return _attend(q, k, v, positions, k_scale, v_scale)
    return _launch(edition(k_scale is not None, False), q, k, v, k_scale, v_scale,
                   None, positions, k.shape[1], SPLIT_ROWS)


def decode_gqa_attention_paged(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor, table: torch.Tensor,
                               positions: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, D]; pool_k, pool_v [P, PAGE_S, Hkv, D]; table int32 [B,
    NP] of page ids in [0, P); positions int32 [B] → [B, H, D]. With f32
    scale pools [P, PAGE_S, Hkv] the rows are int8 (K4), else in q's
    dtype (K3). One kernel block reads one page."""
    _check(q, pool_k, pool_v, positions, k_scale, v_scale, table)
    if q.device.type == "cpu":
        return decode_gqa_attention_paged_ref(q, pool_k, pool_v, table, positions,
                                              k_scale, v_scale)
    page_s = pool_k.shape[1]
    return _launch(edition(k_scale is not None, True), q, pool_k, pool_v, k_scale,
                   v_scale, table, positions, table.shape[1] * page_s, page_s)
