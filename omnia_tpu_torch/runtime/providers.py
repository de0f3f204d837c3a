"""Provider specs → the port's engine (port of the builder half of
``omnia_tpu/runtime/providers.py``).

A provider spec names a model and the engine options; ``build_engine``
turns it into an :class:`~omnia_tpu_torch.engine.InferenceEngine` on the
card. Type ``"tpu"`` means the in-tree engine, which in this package is
the port's: from a ``checkpoint_path`` (an HF-layout directory, whose
``config.json`` is the architecture authority) or from a preset with
random weights drawn from ``seed``.

One difference from the JAX builder: with ``quant`` set, the loader
quantizes layer by layer as it places the weights
(``models/checkpoint.py``), so a 70B checkpoint's full-precision tree
never reaches the card; the JAX builder loads full precision and its
engine quantizes afterwards. Both give the same int8 tree.

Parallelism: ``dp``, ``sp`` and ``tp`` pass through to the engine. When the
distributed env is set (``OMNIA_COORDINATOR_ADDR``,
``parallel/distributed.py``) ``build_engine`` joins the process group, each
rank's loader reads only its slice, and the engine comes back wrapped in
a :class:`~omnia_tpu_torch.engine.multihost.LockstepEngine`: rank 0 serves
it, every other rank calls its ``run_follower()``.
"""

from __future__ import annotations

import dataclasses

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
from omnia_tpu_torch.engine.types import resolve_dtype
from omnia_tpu_torch.models import PRESETS, get_config
from omnia_tpu_torch.models import checkpoint as ckpt_io
from omnia_tpu_torch.parallel.distributed import maybe_initialize_distributed
from omnia_tpu_torch.parallel.mesh import make_mesh


class ProviderError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ProviderSpec:
    name: str
    type: str = "tpu"  # tpu | mock | tone | cartesia | elevenlabs | openai
    role: str = "llm"              # llm | embedding | tts | stt
    model: str = "llama3-8b"       # ModelConfig preset name
    # Engine placement/shape options (forwarded to EngineConfig).
    options: dict = dataclasses.field(default_factory=dict)
    # Pricing for cost accounting on Usage (per 1M tokens).
    input_cost_per_mtok: float = 0.0
    output_cost_per_mtok: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "ProviderSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ProviderError(f"unknown provider fields: {sorted(unknown)}")
        return cls(**d)


# The EngineConfig fields a spec's options may set: the JAX package's
# build_engine list, and decode_ring, sp and long_prefill_threshold,
# which that list drops (a spec asking for them gets them here).
_ENGINE_OPTIONS = frozenset({
    "num_slots", "max_seq", "prefill_buckets", "dtype",
    "dp", "tp", "sp", "long_prefill_threshold", "decode_chunk", "decode_pipeline",
    "spec_decode", "spec_decode_max", "spec_gate_window",
    "quant", "kv_quant", "max_sessions",
    "prefix_cache_slots", "prefix_cache_rows",
    "prefix_cache_publish_threshold",
    "prefix_cache_min_tokens", "prefix_cache_host_entries",
    "grammar", "grammar_max_states",
    "max_queue", "watchdog_s",
    "flight_events",
    "kv_pages", "kv_page_tokens",
    "warmup_threads", "decode_ring",
})


def build_engine(spec: ProviderSpec, *, warmup: bool = False, device=None,
                 coldstart=None, finish_reasons=None):
    """Instantiate the engine for a provider spec, on ``device`` (the card
    unless the caller names another). ``finish_reasons`` is the enum class
    the engine's final events carry (the JAX runtime's own, to serve
    under it); ``coldstart`` a ColdStartTracker that records the build's
    phases and the checkpoint's byte progress (either package's: the
    engine calls only its methods). Only type ``"tpu"`` is ported: the
    mock engine raises ``ProviderError``.

    With the distributed env set this rank joins the process group (nccl
    on a card, gloo without, unless the caller joined it already) and gets
    a ``LockstepEngine`` around its engine."""
    if spec.type == "mock":
        raise ProviderError("provider type 'mock' is not ported to omnia_tpu_torch "
                            "yet (ROADMAP A7)")
    if spec.type != "tpu":
        raise ProviderError(f"unknown provider type {spec.type!r}")
    eng_kwargs = {k: v for k, v in spec.options.items() if k in _ENGINE_OPTIONS}
    if "prefill_buckets" in eng_kwargs:
        eng_kwargs["prefill_buckets"] = tuple(eng_kwargs["prefill_buckets"])
    ecfg = EngineConfig(**eng_kwargs)
    distributed = maybe_initialize_distributed() is not None
    device = resolve_device(device)

    params = None
    ckpt = spec.options.get("checkpoint_path")
    if ckpt:
        # Real weights: the checkpoint's config.json is the architecture
        # authority (spec.model is just a label).
        cfg = ckpt_io.read_config(ckpt, name=spec.model or None)
        dtype = resolve_dtype(ecfg.dtype)

        # The engine calls the loader once, after validating its config,
        # under its weights_load phase with byte progress.
        def params(progress_cb=None):
            # Under a mesh each rank reads its own tp slice (the mesh the
            # engine builds, made the same way: it shares its groups).
            mesh = (make_mesh(dp=ecfg.dp, sp=ecfg.sp, tp=ecfg.tp)
                    if ecfg.dp * ecfg.sp * ecfg.tp > 1 else None)
            return ckpt_io.load_params(ckpt, cfg, dtype=dtype, device=device,
                                       quant=ecfg.quant, progress_cb=progress_cb, mesh=mesh)
    else:
        if spec.model not in PRESETS:
            raise ProviderError(
                f"unknown model preset {spec.model!r}; have {sorted(PRESETS)}"
            )
        cfg = get_config(spec.model)
    engine = InferenceEngine(cfg, ecfg, params=params, seed=spec.options.get("seed", 0),
                             device=device, finish_reasons=finish_reasons,
                             coldstart=coldstart)
    if distributed:
        from omnia_tpu_torch.engine.multihost import LockstepEngine

        engine = LockstepEngine(engine)
    if warmup:
        engine.warmup()
    return engine
