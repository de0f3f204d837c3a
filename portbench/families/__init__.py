"""One module per architecture, found by the configuration's ``model_type``.

``portbench/families/<model_type>.py`` turns a configuration file of
that architecture into everything the harness reads off its keys:

- ``model_config(cfg)``: the port's ``ModelConfig``;
- ``leaves(cfg)``: each leaf path of the served tree → (depth, shape of
  one block, std). Depth is the number of blocks stacked on the leaf's
  leading axis (``None`` for a leaf outside the layers), so a family may
  stack, say, its dense leading layers and its MoE layers under two
  prefixes of different depths; std ``None`` marks a norm weight;
- the counts: ``matmul_params_per_token(cfg)``, ``head_params(cfg)``,
  ``prefill_flops(cfg, n)``, ``decode_flops(cfg, position)`` and
  ``decode_attention_bytes(cfg, position, itemsize)``;
- ``reference_logits(cfg, seed, sequences, wanted, precision, device,
  dtype)``: float32 logits of its plain reference (a torch-only file
  under ``portbench/reference/``) at precision ``f32``, ``fp8`` (the
  control) or ``bf16`` (the witness), the weights drawn again from the
  seed one block at a time (``portbench.weights.block``);
- optionally ``mesh_param_specs(mcfg, mesh)``, the spec tree a rank's
  slice is cut by; without it the family runs on one card only.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def path(model_type) -> Path:
    """Where the family of ``model_type`` lives."""
    return HERE / f"{model_type}.py"


def of(cfg: dict):
    """The family module of a configuration, by its ``model_type``."""
    return importlib.import_module(f"{__name__}.{cfg['model_type']}")
