"""HF-layout checkpoint I/O: safetensors ⇄ the port's stacked param tree
(port of ``omnia_tpu/models/checkpoint.py``).

Reads HuggingFace-layout llama and mixtral checkpoints (``config.json`` +
``*.safetensors`` [+ ``model.safetensors.index.json``]) into the stacked
``[L, ...]`` tree that ``models/llama.py`` consumes, and writes it back.

- **Its own safetensors reader and writer**, in numpy: an 8-byte
  little-endian header length, a JSON header of ``{name: {dtype, shape,
  data_offsets}}`` (``__metadata__`` beside them), padded to 8 bytes,
  then the raw buffer. Files are read through ``np.memmap``; BF16 data is
  read as 16-bit integers and viewed as ``torch.bfloat16``, which is
  exact. F32, F16, BF16 and I8 are handled.
- **Layer by layer**: each stacked leaf is allocated once on the target
  device and filled one layer at a time; with ``quant`` each layer is
  quantized on the device as it is placed (scales are per layer and
  output channel, so the tree is the same bit for bit as quantizing the
  whole leaf). Host memory holds about one layer, never the model.
- **Mixtral**: the router (``block_sparse_moe.gate``, ``[E, D]`` on
  disk) and each expert's ``w1`` / ``w3`` / ``w2`` stack into ``router
  [L, D, E]``, ``wg`` / ``wu [L, E, D, F]`` and ``wd [L, E, F, D]``, and
  stay full precision under ``quant``, as in the JAX loader.
- **Convention**: PyTorch ``nn.Linear`` stores ``[out, in]``; this tree
  right-multiplies activations, so projections transpose on load. RoPE is
  the rotate-half convention transformers uses for llama: no head
  permutation.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.models import quant as quant_mod
from omnia_tpu_torch.models.config import ModelConfig


class CheckpointError(ValueError):
    pass


# ---------------------------------------------------------------------------
# config.json ⇄ ModelConfig
# ---------------------------------------------------------------------------


_SUPPORTED_MODEL_TYPES = {"llama", "mixtral"}


def _parse_rope_scaling(d: dict):
    """HF rope_scaling → the hashable tuple ModelConfig carries. Silently
    dropping an unsupported scheme would serve garbled long-context
    generations with no error, so anything unrecognized raises."""
    rs = d.get("rope_scaling")
    if rs is None:
        return None
    rope_type = rs.get("rope_type") or rs.get("type")
    if rope_type == "default":
        return None
    if rope_type != "llama3":
        raise CheckpointError(
            f"unsupported rope_scaling type {rope_type!r} (supported: llama3)"
        )
    try:
        return (
            float(rs["factor"]),
            float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    except KeyError as e:
        raise CheckpointError(f"rope_scaling missing field {e}") from e


def hf_config_to_model(d: dict, name: str = "checkpoint") -> ModelConfig:
    """Map a HuggingFace llama/mixtral config.json dict to a ModelConfig."""
    model_type = d.get("model_type")
    if model_type is not None and model_type not in _SUPPORTED_MODEL_TYPES:
        raise CheckpointError(
            f"unsupported model_type {model_type!r} "
            f"(supported: {sorted(_SUPPORTED_MODEL_TYPES)})"
        )
    try:
        n_heads = int(d["num_attention_heads"])
        hidden = int(d["hidden_size"])
        cfg = ModelConfig(
            name=name,
            vocab_size=int(d["vocab_size"]),
            hidden_size=hidden,
            num_layers=int(d["num_hidden_layers"]),
            num_heads=n_heads,
            num_kv_heads=int(d.get("num_key_value_heads") or n_heads),
            head_dim=int(d.get("head_dim") or hidden // n_heads),
            ffn_hidden_size=int(d["intermediate_size"]),
            rope_theta=float(d.get("rope_theta", 10000.0)),
            rope_scaling=_parse_rope_scaling(d),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-5)),
            tie_embeddings=bool(d.get("tie_word_embeddings", False)),
            num_experts=int(d.get("num_local_experts") or 0),
            num_experts_per_tok=int(d.get("num_experts_per_tok") or 2),
            max_seq_len=int(d.get("max_position_embeddings", 8192)),
        )
    except KeyError as e:
        raise CheckpointError(f"config.json missing required field {e}") from e
    return cfg


def model_to_hf_config(cfg: ModelConfig) -> dict:
    arch = "MixtralForCausalLM" if cfg.is_moe else "LlamaForCausalLM"
    d = {
        "architectures": [arch],
        "model_type": "mixtral" if cfg.is_moe else "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.ffn_hidden_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "max_position_embeddings": cfg.max_seq_len,
    }
    if cfg.is_moe:
        d["num_local_experts"] = cfg.num_experts
        d["num_experts_per_tok"] = cfg.num_experts_per_tok
    if cfg.rope_scaling is not None:
        factor, low, high, orig = cfg.rope_scaling
        d["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": factor,
            "low_freq_factor": low,
            "high_freq_factor": high,
            "original_max_position_embeddings": orig,
        }
    return d


def read_config(path: str, name: Optional[str] = None) -> ModelConfig:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise CheckpointError(f"no config.json under {path}")
    with open(cfg_path) as f:
        d = json.load(f)
    return hf_config_to_model(d, name=name or os.path.basename(path.rstrip("/")))


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------

# safetensors dtype code → (numpy dtype of the stored bits, torch dtype).
# numpy has no bfloat16: its bits are read as int16 and viewed.
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I8": (np.int8, torch.int8),
}
_CODES = {t: code for code, (_, t) in _DTYPES.items()}


def _read_header(fp: str) -> tuple[dict, int]:
    """A safetensors file's header and the file offset of its buffer."""
    with open(fp, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def write_safetensors(fp: str, tensors: dict, metadata: Optional[dict] = None) -> None:
    """Write CPU tensors as one safetensors file. Wider dtypes come first in
    the buffer, so every tensor starts aligned to its element size."""
    order = sorted(tensors, key=lambda k: -tensors[k].element_size())
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise CheckpointError(f"{name}: cannot write dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = metadata
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(fp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(tensors[name].contiguous().reshape(-1).view(torch.uint8).numpy().data)


class _ShardReader:
    """name → CPU tensor across a (possibly sharded) safetensors checkpoint.
    Each shard is memory-mapped once, copy-on-write, so a tensor is a view
    of the page cache until it is copied to the device."""

    def __init__(self, path: str):
        self.path = path
        self._files: dict = {}
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                self._map = dict(json.load(f)["weight_map"])
        else:
            files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
            if not files:
                raise CheckpointError(f"no *.safetensors under {path}")
            self._map = {}
            for fp in files:
                for k in _read_header(fp)[0]:
                    if k != "__metadata__":
                        self._map[k] = os.path.basename(fp)

    def names(self) -> set:
        return set(self._map)

    def has(self, name: str) -> bool:
        return name in self._map

    def _open(self, fname: str):
        if fname not in self._files:
            fp = os.path.join(self.path, fname)
            header, start = _read_header(fp)
            buf = np.memmap(fp, dtype=np.uint8, mode="c", offset=start)
            self._files[fname] = (header, buf)
        return self._files[fname]

    def get(self, name: str) -> torch.Tensor:
        if name not in self._map:
            raise CheckpointError(f"tensor {name!r} not in checkpoint")
        header, buf = self._open(self._map[name])
        info = header[name]
        if info["dtype"] not in _DTYPES:
            raise CheckpointError(
                f"{name}: unsupported dtype {info['dtype']!r} (have {sorted(_DTYPES)})"
            )
        np_dt, torch_dt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = buf[begin:end].view(np_dt).reshape(info["shape"])
        return torch.from_numpy(arr).view(torch_dt)


# ---------------------------------------------------------------------------
# Tensor name mapping (HF llama / mixtral layout)
# ---------------------------------------------------------------------------

_ATTN = {
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
}
_DENSE_MLP = {
    "wg": "model.layers.{i}.mlp.gate_proj.weight",
    "wu": "model.layers.{i}.mlp.up_proj.weight",
    "wd": "model.layers.{i}.mlp.down_proj.weight",
}


_MOE = {
    "router": "model.layers.{i}.block_sparse_moe.gate.weight",
    "wg": "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    "wu": "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
    "wd": "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
}


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def expected_param_bytes(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> int:
    """Host bytes ``load_params`` will stream for this config at ``dtype``
    (pre-quantization — what actually crosses from the checkpoint). The
    denominator of the loader's byte-level progress callback."""
    D, F, V, L = cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size, cfg.num_layers
    per_layer = 2 * D + D * cfg.q_dim + 2 * (D * cfg.kv_dim) + cfg.q_dim * D
    if cfg.is_moe:
        per_layer += D * cfg.num_experts + cfg.num_experts * (2 * D * F + F * D)
    else:
        per_layer += 2 * D * F + F * D
    elements = V * D + L * per_layer + D
    if not cfg.tie_embeddings:
        elements += D * V
    return elements * dtype.itemsize


def load_params(
    path: str,
    cfg: Optional[ModelConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    quant: Optional[str] = None,
    progress_cb=None,
    mesh=None,
) -> dict:
    """Load an HF-layout llama or mixtral checkpoint into the stacked tree on
    ``device`` (the card unless the caller names another).

    Every leaf is allocated once on the device and filled layer by layer
    from the memory-mapped files, cast to ``dtype`` on the host first.
    With ``quant`` ("int8" / "int8-dynamic", ``models/quant.py``) the
    matmul weights are allocated int8 and each layer is quantized on the
    device as it lands, so the full-precision tree never reaches the card
    and host memory peaks at about one layer.

    With a ``mesh`` every leaf is this rank's slice by
    ``llama.param_specs`` (``quant.quantize_param_specs`` under
    ``quant``): each layer is cut on the host before its cast and copy,
    and a quantized layer is quantized whole (a row-parallel weight's
    scales span its whole contraction) and then cut, so no rank ever
    holds more than one whole layer of the tree.

    With ``progress_cb``, ``progress_cb(loaded_bytes, total_bytes)`` is
    called after every tensor read, metered at ``dtype`` (what
    ``expected_param_bytes`` counts), so it ends at exactly 100%.
    """
    from omnia_tpu_torch.models.llama import param_specs
    from omnia_tpu_torch.parallel.sharding import P, shard_leaf, shard_pytree

    cfg = cfg or read_config(path)
    quant_mod.validate_mode(quant)
    device = resolve_device(device)
    total_bytes = expected_param_bytes(cfg, dtype)
    loaded_bytes = 0
    reader = _ShardReader(path)
    L, D, F, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    specs = param_specs(cfg)
    if quant is not None:
        specs = quant_mod.quantize_param_specs(specs, cfg, quant)
    sa, sm = specs["layers"]["attn"], specs["layers"]["mlp"]

    def local(shape: tuple, spec) -> tuple:
        """This rank's shape of a leaf of ``shape`` split by ``spec``."""
        return tuple(n // mesh.size(a) if mesh is not None and a else n
                     for n, a in zip(shape, spec))

    def fetch(name: str, want_shape: tuple, transpose: bool, spec=None) -> torch.Tensor:
        """One tensor, this rank's slice by ``spec`` when given (a mesh),
        cast to ``dtype``."""
        nonlocal loaded_bytes
        t = reader.get(name)
        if transpose:
            t = t.T  # torch Linear [out,in] → right-multiply [in,out]
        if tuple(t.shape) != want_shape:
            raise CheckpointError(
                f"{name}: shape {tuple(t.shape)} != expected {want_shape}"
                f"{' (after transpose)' if transpose else ''}"
            )
        if progress_cb is not None:
            loaded_bytes += t.numel() * dtype.itemsize
            progress_cb(loaded_bytes, total_bytes)
        if mesh is not None and spec is not None:
            t = shard_leaf(t, spec, mesh)
        return t.to(dtype)

    def empty(shape: tuple, spec):
        if isinstance(spec, dict):
            return quant_mod.empty_weight(local(shape, spec[quant_mod._key_for(quant)]),
                                          quant, device)
        return torch.empty(local(shape, spec), dtype=dtype, device=device)

    def drop_layer_axis(spec):
        if isinstance(spec, dict):
            return {k: P(*v[1:]) for k, v in spec.items()}
        return P(*spec[1:])

    def place(leaf, index, name: str, shape: tuple, transpose: bool, spec) -> None:
        """Write one layer (``index`` i, ``spec`` without the layer axis)
        or a whole leaf (``index`` ())."""
        if not quant_mod.is_quantized(leaf):
            leaf[index].copy_(fetch(name, shape, transpose, spec))
        elif mesh is None:
            quant_mod.quantize_into(leaf, fetch(name, shape, transpose), index)
        else:
            whole = quant_mod.empty_weight(shape, quant, device)
            quant_mod.quantize_into(whole, fetch(name, shape, transpose))
            for k, v in shard_pytree(whole, spec, mesh).items():
                leaf[k][index].copy_(v)

    def single(name: str, shape: tuple, spec, transpose=False):
        leaf = empty(shape, spec)
        place(leaf, (), name, shape, transpose, spec)
        return leaf

    def stacked(tmpl: str, shape: tuple, spec, transpose=True):
        leaf = empty((L, *shape), spec)
        for i in range(L):
            place(leaf, i, tmpl.format(i=i), shape, transpose, drop_layer_axis(spec))
        return leaf

    def stacked_experts(tmpl: str, shape: tuple, spec):
        E = cfg.num_experts
        leaf = empty((L, E, *shape), spec)
        n = leaf.shape[1]
        e0 = 0 if mesh is None else mesh.index(spec[1]) * n
        for i in range(L):
            for e in range(E):
                t = fetch(tmpl.format(i=i, e=e), shape, True)
                if e0 <= e < e0 + n:
                    leaf[i, e - e0].copy_(t)
        return leaf

    attn = {
        "wq": stacked(_ATTN["wq"], (D, cfg.q_dim), sa["wq"]),
        "wk": stacked(_ATTN["wk"], (D, cfg.kv_dim), sa["wk"]),
        "wv": stacked(_ATTN["wv"], (D, cfg.kv_dim), sa["wv"]),
        "wo": stacked(_ATTN["wo"], (cfg.q_dim, D), sa["wo"]),
    }
    if cfg.is_moe:
        mlp = {
            "router": stacked(_MOE["router"], (D, cfg.num_experts), sm["router"]),
            "wg": stacked_experts(_MOE["wg"], (D, F), sm["wg"]),
            "wu": stacked_experts(_MOE["wu"], (D, F), sm["wu"]),
            "wd": stacked_experts(_MOE["wd"], (F, D), sm["wd"]),
        }
    else:
        mlp = {
            "wg": stacked(_DENSE_MLP["wg"], (D, F), sm["wg"]),
            "wu": stacked(_DENSE_MLP["wu"], (D, F), sm["wu"]),
            "wd": stacked(_DENSE_MLP["wd"], (F, D), sm["wd"]),
        }
    lay = specs["layers"]
    params = {
        "embed": single("model.embed_tokens.weight", (V, D), specs["embed"]),
        "layers": {
            "ln1": stacked("model.layers.{i}.input_layernorm.weight", (D,), lay["ln1"],
                           transpose=False),
            "ln2": stacked("model.layers.{i}.post_attention_layernorm.weight", (D,),
                           lay["ln2"], transpose=False),
            "attn": attn,
            "mlp": mlp,
        },
        "final_norm": single("model.norm.weight", (D,), specs["final_norm"]),
    }
    if not cfg.tie_embeddings:
        # Some checkpoints omit lm_head and tie on load; honor that.
        name = "lm_head.weight" if reader.has("lm_head.weight") else "model.embed_tokens.weight"
        params["lm_head"] = single(name, (D, V), specs["lm_head"], transpose=True)
    return params


# ---------------------------------------------------------------------------
# Saving (HF layout back out; also the round-trip test harness)
# ---------------------------------------------------------------------------


def save_params(
    params,
    cfg: ModelConfig,
    path: str,
    max_shard_bytes: int = 2 * 1024**3,
) -> None:
    """Write the stacked tree as an HF-layout safetensors checkpoint
    (config.json + shard files + index when more than one shard). One
    tensor at a time crosses to the host, so host memory stays ~one
    shard."""
    if quant_mod.params_quantized(params):
        raise CheckpointError(
            "save_params writes HF-layout full-precision checkpoints; "
            "int8-quantized trees are a serving format — load with "
            "load_params(quant=...) instead of persisting them"
        )

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model_to_hf_config(cfg), f, indent=2)

    def host(x: torch.Tensor) -> torch.Tensor:
        return x.detach().contiguous().cpu()

    def tensors():
        lay = params["layers"]
        yield "model.embed_tokens.weight", host(params["embed"])
        for i in range(cfg.num_layers):
            yield f"model.layers.{i}.input_layernorm.weight", host(lay["ln1"][i])
            yield f"model.layers.{i}.post_attention_layernorm.weight", host(lay["ln2"][i])
            for key, tmpl in _ATTN.items():
                yield tmpl.format(i=i), host(lay["attn"][key][i].T)
            if cfg.is_moe:
                yield _MOE["router"].format(i=i), host(lay["mlp"]["router"][i].T)
                for e in range(cfg.num_experts):
                    for key in ("wg", "wu", "wd"):
                        yield _MOE[key].format(i=i, e=e), host(lay["mlp"][key][i, e].T)
            else:
                for key, tmpl in _DENSE_MLP.items():
                    yield tmpl.format(i=i), host(lay["mlp"][key][i].T)
        yield "model.norm.weight", host(params["final_norm"])
        if not cfg.tie_embeddings:
            yield "lm_head.weight", host(params["lm_head"].T)

    # Greedy size-based sharding, each shard written (and freed) as it
    # fills. Files get temp names because the final HF-style names need the
    # total shard count, unknown until the end; renames are cheap.
    tmp_names: list[str] = []
    shard_names: list[list[str]] = []
    shard: dict = {}
    size = 0
    total = 0

    def flush():
        nonlocal shard, size
        if not shard:
            return
        fname = f"model.tmp-{len(tmp_names)}.safetensors"
        write_safetensors(os.path.join(path, fname), shard, metadata={"format": "pt"})
        tmp_names.append(fname)
        shard_names.append(list(shard))
        shard = {}
        size = 0

    for name, t in tensors():
        nbytes = t.numel() * t.element_size()
        if size > 0 and size + nbytes > max_shard_bytes:
            flush()
        shard[name] = t
        size += nbytes
        total += nbytes
    flush()

    if len(tmp_names) == 1:
        os.replace(
            os.path.join(path, tmp_names[0]), os.path.join(path, "model.safetensors")
        )
        return
    weight_map = {}
    n = len(tmp_names)
    for idx, (tmp, names) in enumerate(zip(tmp_names, shard_names), start=1):
        fname = f"model-{idx:05d}-of-{n:05d}.safetensors"
        os.replace(os.path.join(path, tmp), os.path.join(path, fname))
        for name in names:
            weight_map[name] = fname
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
