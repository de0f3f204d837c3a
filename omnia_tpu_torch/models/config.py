"""Model configurations for the omnia_tpu_torch model family.

The port's own copy of ``omnia_tpu/models/config.py``: the same
``ModelConfig`` fields, presets and ``get_config``, kept field for field
so that a configuration means the same model in both packages. Presets
cover Llama-3-8B / 70B and Mixtral-8x7B, plus tiny variants for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    ffn_hidden_size: int = 14336
    rope_theta: float = 500000.0
    # Llama-3.1 'llama3' rope_type long-context frequency remap, as a
    # hashable tuple (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain RoPE.
    rope_scaling: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE (Mixtral-style). num_experts == 0 means dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Maximum sequence length the serving engine sizes KV caches for.
    max_seq_len: int = 8192

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Approximate parameter count (for memory planning)."""
        d, f, v = self.hidden_size, self.ffn_hidden_size, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.is_moe:
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d


PRESETS: dict[str, ModelConfig] = {
    # Flagship serving target (BASELINE config 2/3).
    "llama3-8b": ModelConfig(
        name="llama3-8b",
        vocab_size=128256,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        ffn_hidden_size=14336,
        rope_theta=500000.0,
        max_seq_len=8192,
    ),
    # Batch-eval target (BASELINE config 5).
    "llama3-70b": ModelConfig(
        name="llama3-70b",
        vocab_size=128256,
        hidden_size=8192,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        ffn_hidden_size=28672,
        rope_theta=500000.0,
        max_seq_len=8192,
    ),
    # Tool-calling MoE target (BASELINE config 4).
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        ffn_hidden_size=14336,
        rope_theta=1000000.0,
        num_experts=8,
        num_experts_per_tok=2,
        max_seq_len=8192,
    ),
    # ~1B-class model.
    "llama3-1b": ModelConfig(
        name="llama3-1b",
        vocab_size=128256,
        hidden_size=2048,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        ffn_hidden_size=8192,
        rope_theta=500000.0,
        max_seq_len=8192,
    ),
    # Tiny configs for tests (fast compile on CPU).
    "test-tiny": ModelConfig(
        name="test-tiny",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        ffn_hidden_size=128,
        rope_theta=10000.0,
        max_seq_len=128,
    ),
    "test-tiny-gqa8": ModelConfig(
        name="test-tiny-gqa8",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        ffn_hidden_size=128,
        rope_theta=10000.0,
        max_seq_len=128,
    ),
    "test-tiny-moe": ModelConfig(
        name="test-tiny-moe",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        ffn_hidden_size=128,
        rope_theta=10000.0,
        num_experts=4,
        num_experts_per_tok=2,
        max_seq_len=128,
    ),
}


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
