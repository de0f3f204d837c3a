"""Decode attention (K1): the port's plain version against the JAX Pallas
kernel run in interpret mode on the CPU, the CPU route of the wrapper,
and — on a card only — the CUDA kernel against the plain version."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.ops.decode_attention import decode_gqa_attention as jax_decode
from omnia_tpu_torch.ops import decode_attention as tda

BF16_NP = jnp.bfloat16  # numpy-compatible bf16 dtype (ml_dtypes) for JAX inputs


def _inputs(B=3, S=256, H=8, Hkv=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


# Positions 0, mid-block and S-1 (block_s = 128 in the JAX kernel).
POSITIONS = [0, 77, 255]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_pallas_interpret(dtype):
    q, k, v = _inputs()
    pos = np.array(POSITIONS, np.int32)
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a, BF16_NP) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                      for a in (jq, jk, jv))
        # bf16 output: two bf16 ulps at magnitude ~1 plus rounding-order slack.
        atol = 2e-2
    else:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        atol = 1e-5  # f32, summation order only
    ref = jax_decode(jq, jk, jv, jnp.asarray(pos), block_s=128, interpret=True)
    out = tda.decode_gqa_attention_ref(tq, tk, tv, torch.from_numpy(pos))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


def test_nan_rows_past_position_do_not_influence():
    q, k, v = _inputs(seed=1)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    clean = tda.decode_gqa_attention(tq, tk, tv, pos)
    kp, vp = tk.clone(), tv.clone()
    for b, p in enumerate(POSITIONS):
        kp[b, p + 1:] = float("nan")
        vp[b, p + 1:] = float("nan")
    poisoned = tda.decode_gqa_attention(tq, kp, vp, pos)
    assert torch.isfinite(poisoned).all()
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)


def test_wrapper_rejects_unsupported_shapes():
    q, k, v = map(torch.from_numpy, _inputs(D=64))
    pos = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_gqa_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                 v[..., :32].contiguous(), pos)
    with pytest.raises(ValueError, match="int32"):
        tda.decode_gqa_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="dtypes"):
        tda.decode_gqa_attention(q.double(), k.double(), v.double(), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cuda_kernel_matches_plain(dtype, atol, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in _inputs(B=4, S=300, H=8, Hkv=1 if D == 16 else 2, D=D))
    pos = torch.tensor([0, 63, 64, 299], dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos.tolist()):
        k[b, p + 1:] = float("nan")
        v[b, p + 1:] = float("nan")
    before = tda.decode_gqa_attention.launches
    out = tda.decode_gqa_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert tda.decode_gqa_attention.launches == before + 1
    ref = tda.decode_gqa_attention_ref(q, k, v, pos)
    # f32: summation order only; bf16: two bf16 ulps at magnitude 1.
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
