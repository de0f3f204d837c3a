"""Conversion of a JAX param pytree into the port's params.

The port keeps the JAX layout (stacked layers, projections [in, out]),
so conversion is a copy leaf by leaf. Leaves arrive as numpy arrays; a
bfloat16 leaf (numpy dtype name ``"bfloat16"``, from ml_dtypes) is read
through a ``uint16`` view of its bits, so neither jax nor ml_dtypes is
imported here. Quantized weights (``{"w8"|"w8d": int8, "s": f32}``,
``models/quant.py``) carry over with their dtypes, the int8 values in
the layout the port's product reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.models import quant
from omnia_tpu_torch.models.quant import is_quantized, with_product_layout


def _leaf(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # bf16 is the top half of an f32: widen the bits exactly.
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        t = torch.from_numpy(np.ascontiguousarray(bits).view(np.float32))
        dtype = dtype or torch.bfloat16
    else:
        t = torch.from_numpy(np.array(arr, copy=True))  # jax views are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(tree, device, dtype: Optional[torch.dtype]):
    if isinstance(tree, dict):
        if is_quantized(tree):
            return with_product_layout({k: _leaf(v, device, None) for k, v in tree.items()})
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None, mesh=None,
                    cfg=None):
    """Nested dict of numpy arrays (a JAX ``llama.init_params`` tree
    after ``jax.tree.map(np.asarray, ...)``) → the same dict of tensors on
    ``device``, its floating weights cast to ``dtype`` (default: each
    leaf's own dtype). A quantized weight's int8 values and f32 scales
    keep their dtypes. With a ``mesh`` (and the model's ``cfg``) the
    result is this rank's slice by ``llama.param_specs`` (quantized:
    ``quant.quantize_param_specs``), cut on the host before it moves."""
    if mesh is None:
        return _convert(tree, device, dtype)
    from omnia_tpu_torch.models.llama import param_specs
    from omnia_tpu_torch.parallel.sharding import shard_pytree

    specs = param_specs(cfg)
    mode = quant.detect_mode(tree)
    if mode is not None:
        specs = quant.quantize_param_specs(specs, cfg, mode)
    return shard_pytree(_convert(tree, "cpu", dtype), specs, mesh, device)
