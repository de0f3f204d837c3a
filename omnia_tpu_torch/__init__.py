"""PyTorch / CUDA port of the omnia_tpu serving stack.

A package of its own beside ``omnia_tpu``: it imports ``torch`` and
``numpy``, never ``jax`` and no module of ``omnia_tpu``. It mirrors that
package's layout (``models/``, ``ops/``, ``engine/``) so that each
module's counterpart is found by path. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; hand-written kernels live
under ``csrc/`` and are built by :mod:`omnia_tpu_torch.kernels`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda``
    (a rank of a process group: ``cuda:{local_rank % device_count}``).

    Without an explicit device and without CUDA this raises rather than
    quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        from omnia_tpu_torch.parallel.distributed import rank_device

        return rank_device()
    return torch.device("cuda")
