"""The port's embedding role held against the JAX package on the CPU, f32:
``forward_embed`` against the JAX forward on masked rows, ``TorchEmbedder``
against ``TpuEmbedder`` on the byte tokenizer and under the JAX embedder's
contract, and the JAX memory plane (``MemoryAPI``, its ``ReembedWorker``
and ``Retriever``) served by a ``TorchEmbedder``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from omnia_tpu.memory import MemoryAPI, TpuEmbedder
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.engine.tokenizer import ByteTokenizer
from omnia_tpu_torch.memory import TorchEmbedder
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models.convert import params_from_jax

# f32 on both sides: only summation order differs (measured < 1e-7).
ATOL = 1e-5
# The byte tokenizer's ids run to 258 (BOS 256, EOS 257, PAD 258).
VOCAB = 259
TEXTS = ["hello", "a much longer piece of text to embed",
         "x" * 100, "long " * 150]   # 32-, 128- and (truncated) 512-token buckets
WS = "ws-embed"


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params) of test-tiny f32 with the byte
    tokenizer's vocabulary."""
    jcfg = jget_config("test-tiny", vocab_size=VOCAB)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def embedder(models):
    return TorchEmbedder(models[1], get_config("test-tiny", vocab_size=VOCAB),
                         ByteTokenizer(), device="cpu")


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-moe"])
def test_forward_embed_matches_jax_and_pads_do_not_leak(name):
    """Rows with 16, 9, 1 and 0 real tokens: the vectors agree with JAX
    (an all-pad row pools to zeros in both), and new values in the pad
    positions change nothing."""
    jcfg = jget_config(name)
    jparams = jllama.init_params(jcfg, jax.random.key(1), dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(2)
    tok = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 9, 1, 0])[:, None]).astype(np.int32)
    ref = np.asarray(jllama.forward_embed(jparams, jcfg, jnp.asarray(tok), jnp.asarray(mask)))
    got = tllama.forward_embed(tparams, get_config(name), torch.from_numpy(tok),
                               torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (4, jcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ref[:3], axis=-1), 1.0, atol=1e-6)
    assert not ref[3].any() and not got[3].any()
    repadded = np.where(mask == 1, tok, rng.integers(0, jcfg.vocab_size, tok.shape))
    again = tllama.forward_embed(tparams, get_config(name),
                                 torch.from_numpy(repadded.astype(np.int32)),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6, rtol=0)


def test_embedder_matches_tpu_embedder(models, embedder):
    """TorchEmbedder against TpuEmbedder on the byte tokenizer: one batch
    over all three length buckets' texts, and a batch of one."""
    jemb = TpuEmbedder(models[0], jget_config("test-tiny", vocab_size=VOCAB), JByteTokenizer())
    for texts in (TEXTS, TEXTS[1:2], TEXTS[3:]):
        np.testing.assert_allclose(embedder.embed(texts), jemb.embed(texts), atol=ATOL, rtol=0)


def test_embedder_contract(embedder):
    """TpuEmbedder's contract: unit rows of the model's width, pad rows
    that do not leak into real ones, oversize batches split into chunks
    of 32, no texts → no rows."""
    assert embedder.dim == 64
    vecs = embedder.embed(TEXTS[:2])
    assert vecs.shape == (2, 64) and vecs.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(embedder.embed(TEXTS[:1])[0], vecs[0], atol=1e-6)
    many = embedder.embed([f"text {i}" for i in range(TorchEmbedder.BATCH_BUCKETS[-1] + 1)])
    assert many.shape == (33, 64)
    np.testing.assert_allclose(many[32], embedder.embed(["text 32"])[0], atol=1e-6)
    assert embedder.embed([]).shape == (0, 64)


def test_embedder_refusals_and_grad_mode(models):
    """Ids past the model's vocabulary are refused up front (JAX's gather
    would clamp them); params that require grad embed with no graph."""
    with pytest.raises(ValueError, match="vocab"):
        TorchEmbedder(models[1], get_config("test-tiny"), ByteTokenizer(), device="cpu")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), models[1])
    emb = TorchEmbedder(params, get_config("test-tiny", vocab_size=VOCAB), ByteTokenizer(),
                        device="cpu")
    ref = TorchEmbedder(models[1], get_config("test-tiny", vocab_size=VOCAB), ByteTokenizer(),
                        device="cpu")
    np.testing.assert_array_equal(emb.embed(TEXTS[:2]), ref.embed(TEXTS[:2]))


def test_memory_api_over_the_embedder(embedder):
    """Writes through MemoryAPI land unembedded; the ReembedWorker's drain
    embeds every one with the TorchEmbedder; a semantic recall whose query
    shares no word with any entry returns the entry nearest to it by the
    stored vectors, through the vector path (the Retriever would fall back
    to full-text ranking if embedding failed)."""
    api = MemoryAPI(embedder=embedder)
    contents = ["alpha apples orchard", "bravo boats harbour", "charlie cars garage",
                "delta drums studio", "echo eagles canyon"]
    try:
        for c in contents:
            status, _ = api.handle("POST", "/api/v1/memories", {"workspace_id": WS, "content": c})
            assert status == 200
    finally:
        api.reembed.stop()   # the write path's background backfill
    api.reembed.drain()
    assert api.reembed.embedded_total == len(contents)
    entries = api.store.scan(WS)
    assert len(entries) == len(contents) and all(e.embedding is not None for e in entries)
    by_content = {e.content: e for e in entries}
    np.testing.assert_allclose(np.stack([by_content[c].embedding for c in contents]),
                               embedder.embed(contents), atol=1e-6)

    query = "zulu"
    qvec = embedder.embed([query])[0]
    nearest = max(entries, key=lambda e: float(e.embedding @ qvec))
    results = api.retriever.retrieve_semantic(workspace_id=WS, query=query, limit=3)
    assert results[0].entry.id == nearest.id
    assert results[0].vec_rank == 0 and results[0].fts_rank is None
    status, body = api.handle("POST", "/api/v1/memories/retrieve/semantic",
                              {"workspace_id": WS, "query": query, "limit": 3})
    assert status == 200 and body["memories"][0]["id"] == nearest.id
