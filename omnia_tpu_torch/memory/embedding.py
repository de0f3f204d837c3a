"""On-device embedder (port of ``omnia_tpu/memory/embedding.py::TpuEmbedder``).

The memory plane's embedding role runs the model's masked mean-pool
forward (``models/llama.py::forward_embed``) over bucketed shapes:
lengths (32, 128, 512) and batches (1, 8, 32), the JAX embedder's, so
the card sees nine shapes whatever the texts. Texts are truncated to
512 tokens, batches of more than 32 texts run in chunks of 32, and
tokens and mask are zero-padded (a pad row's vector is dropped).

The JAX memory plane (``MemoryAPI``, ``Retriever``, ``ReembedWorker``)
reads only ``.dim`` and ``.embed``, so this class serves it as it is and
subclasses nothing of it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.models import llama


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TorchEmbedder:
    """Tokenizer + ``forward_embed`` on ``device`` (default the card),
    where ``params`` must lie. Runs with grad mode off, so a trainer's
    params serve directly."""

    LEN_BUCKETS = (32, 128, 512)
    BATCH_BUCKETS = (1, 8, 32)

    def __init__(self, params, cfg, tokenizer, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, not {self.device}")
        if tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(f"tokenizer ids reach {tokenizer.vocab_size - 1}, past the "
                             f"model's vocab of {cfg.vocab_size}")
        self._params = params
        self._cfg = cfg
        self._tokenizer = tokenizer
        self.dim = cfg.hidden_size

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Unit vectors np.float32 [len(texts), dim]."""
        max_b = self.BATCH_BUCKETS[-1]
        out = [self._embed_batch(texts[i:i + max_b]) for i in range(0, len(texts), max_b)]
        return np.concatenate(out) if out else np.zeros((0, self.dim), dtype=np.float32)

    @torch.no_grad()
    def _embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        ids = [self._tokenizer.encode(t)[: self.LEN_BUCKETS[-1]] for t in texts]
        T = _bucket(max((len(x) for x in ids), default=1), self.LEN_BUCKETS)
        B = _bucket(len(ids), self.BATCH_BUCKETS)
        tok = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=np.int32)
        for i, row in enumerate(ids):
            tok[i, : len(row)] = row
            mask[i, : len(row)] = 1
        vecs = llama.forward_embed(self._params, self._cfg,
                                   torch.from_numpy(tok).to(self.device),
                                   torch.from_numpy(mask).to(self.device))
        return vecs[: len(texts)].cpu().numpy()
