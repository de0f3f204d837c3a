"""The Mistral / Mixtral decoder: grouped-query attention with rotary
embeddings, and a SwiGLU MLP or, where the file gives
``num_local_experts``, a softmax router over that many SwiGLU experts,
``num_experts_per_tok`` to a token. ``mixtral.py`` is this module.

The served tree is the one ``omnia_tpu_torch.models.llama`` serves:
every layer stacked under ``layers`` and projections stored ``[in,
out]``. Weights keep the usual initializer's scales (the configuration's
``initializer_range``, 0.02 where it gives none, and that / sqrt(2L) for
the output projections). The counts come from the configuration's keys
and the traffic's own lengths and positions; the reference is
``portbench/reference/model.py``.
"""

from __future__ import annotations

from portbench import weights
from portbench.reference import model as ref

__all__ = ["dims", "model_config", "leaves", "matmul_params_per_token", "head_params",
           "attention_flops", "prefill_flops", "decode_flops", "decode_attention_bytes",
           "reference_logits", "mesh_param_specs"]


def dims(cfg: dict) -> dict:
    """The sizes the counts need, from a configuration file's keys."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], D=D, H=H, Hkv=cfg["num_key_value_heads"],
                Dh=cfg.get("head_dim") or D // H, F=cfg["intermediate_size"],
                V=cfg["vocab_size"], E=cfg.get("num_local_experts", 0),
                K=cfg.get("num_experts_per_tok", 0))


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from omnia_tpu_torch.models.config import ModelConfig

    d = dims(cfg)
    return ModelConfig(
        name=cfg["name"], vocab_size=d["V"], hidden_size=d["D"], num_layers=d["L"],
        num_heads=d["H"], num_kv_heads=d["Hkv"], head_dim=d["Dh"], ffn_hidden_size=d["F"],
        rope_theta=float(cfg["rope_theta"]), rms_norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=bool(cfg.get("tie_word_embeddings")), num_experts=d["E"],
        num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        max_seq_len=cfg["max_position_embeddings"])


def leaves(cfg: dict) -> dict:
    """Leaf path → (depth, shape of one block, std): every layer's leaf
    stacked L deep under ``layers``; std None for a norm weight."""
    d = dims(cfg)
    L, D, Dh, F, E = d["L"], d["D"], d["Dh"], d["F"], d["E"]
    std = cfg.get("initializer_range", 0.02)
    out_std = std / (2 * L) ** 0.5
    experts = (E,) if E else ()
    layer = {"ln1": ((D,), None), "ln2": ((D,), None),
             "attn.wq": ((D, d["H"] * Dh), std), "attn.wk": ((D, d["Hkv"] * Dh), std),
             "attn.wv": ((D, d["Hkv"] * Dh), std), "attn.wo": ((d["H"] * Dh, D), out_std)}
    if E:
        layer["mlp.router"] = ((D, E), std)
    layer.update({"mlp.wg": ((*experts, D, F), std), "mlp.wu": ((*experts, D, F), std),
                  "mlp.wd": ((*experts, F, D), out_std)})
    out = {"embed": (None, (d["V"], D), std)}
    out.update({f"layers.{k}": (L, *v) for k, v in layer.items()})
    out["final_norm"] = (None, (D,), None)
    if not cfg.get("tie_word_embeddings"):
        out["lm_head"] = (None, (D, d["V"]), std)
    return out


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through the layers: attention's four
    projections and, dense, the three MLP matrices; MoE, the router and
    the three matrices of each of its top-k experts. The output head is
    counted apart (``head_params``): only a token whose logits are used
    needs it."""
    d = dims(cfg)
    attn = d["D"] * (d["H"] + 2 * d["Hkv"]) * d["Dh"] + d["H"] * d["Dh"] * d["D"]
    mlp = 3 * d["D"] * d["F"]
    if d["E"]:
        mlp = d["K"] * mlp + d["D"] * d["E"]
    return d["L"] * (attn + mlp)


def head_params(cfg: dict) -> int:
    d = dims(cfg)
    return d["D"] * d["V"]


def attention_flops(cfg: dict, context: int) -> float:
    """Attention FLOPs of one query row over ``context`` keys, all layers:
    q·k and p·v, two FLOPs a multiply-add."""
    d = dims(cfg)
    return 4.0 * d["L"] * d["H"] * d["Dh"] * context


def prefill_flops(cfg: dict, n: int) -> float:
    """A fresh prompt of n tokens: the projections for each row, causal
    attention (row i sees i + 1 keys) and one row through the head."""
    d = dims(cfg)
    causal = 4.0 * d["L"] * d["H"] * d["Dh"] * n * (n + 1) / 2
    return 2.0 * matmul_params_per_token(cfg) * n + causal + 2.0 * head_params(cfg)


def decode_flops(cfg: dict, position: int) -> float:
    """One decode token fed at ``position``: the projections, attention
    over positions 0..position, and the head."""
    return (2.0 * (matmul_params_per_token(cfg) + head_params(cfg))
            + attention_flops(cfg, position + 1))


def decode_attention_bytes(cfg: dict, position: int, itemsize: int = 2) -> int:
    """Bytes that the decode-attention kernel needs for one active slot at
    ``position`` over all layers: its q row, its K and V rows 0..position
    and its output row, each read or written once."""
    d = dims(cfg)
    kv = 2 * (position + 1) * d["Hkv"] * d["Dh"]
    q_out = 2 * d["H"] * d["Dh"]
    return d["L"] * (kv + q_out) * itemsize


def reference_logits(cfg: dict, seed: int, sequences: list, wanted: list, precision: str,
                     device, dtype) -> list:
    """The plain reference's float32 logits, layer by layer from the seed."""
    return ref.logits_at(lambda i: weights.layer(cfg, seed, i, device, dtype),
                         weights.globals_(cfg, seed, device, dtype), cfg, sequences, wanted,
                         precision, device)


def mesh_param_specs(mcfg, mesh) -> dict:
    from omnia_tpu_torch.models import llama

    return llama.mesh_param_specs(mcfg, mesh)
