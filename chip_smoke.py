"""Smoke run of omnia_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (exit code != 0, no result line):

1. Device line: torch / CUDA / nvcc / Triton versions and the card's
   name and power limit. Exits 2 when torch.cuda.is_available() is false.
2. Kernel build: every source under omnia_tpu_torch/csrc, one nvcc each,
   all started together.
3. Kernel vs plain: the decode-attention kernel (K1) against its plain
   PyTorch version at the llama3-8b and llama3-1b decode shapes, in bf16
   and f32, with the cache rows past each position poisoned with NaN;
   kernel, plain and library-call times beside the bandwidth bound.
4. Reference: on a small model the card's forward (kernel route) and the
   CPU's (plain route) give the same logits from the same weights.
5. Main path: the port's InferenceEngine at full llama3-8b width and
   depth (bf16, random seeded weights, default EngineConfig) serves 12
   requests through submit(); the kernel's launch count over that run
   must equal num_layers x the decode steps run.

Prints a ``kernels`` JSON line, then the card's name and power limit,
then as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from omnia_tpu_torch import kernels
from omnia_tpu_torch.engine import EngineConfig, FinishReason, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.ops import decode_attention as k1

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
POSITIONS = [0, 1, 255, 256, 511, 700, 1022, 1023]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
TIMED_LAUNCHES = 50


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# -- phase 1 ---------------------------------------------------------------

def device_line() -> str:
    nvcc = kernels.find_nvcc()
    release = "absent"
    if nvcc:
        m = re.search(r"release ([\d.]+)", run([nvcc, "--version"]))
        release = m.group(1) if m else "unknown"
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {release} "
          f"triton {triton_v} python {sys.version.split()[0]}", flush=True)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip()
    return smi.splitlines()[0] if smi else "nvidia-smi: no output"


def ptxas_summary(src: str) -> str:
    """Registers and spills over every kernel in a source's ptxas report."""
    log = kernels.library_path(src).with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores {spills} bytes in all")


# -- phase 3 ---------------------------------------------------------------

def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of one call, L2 flushed before each (the decode
    step finds each layer's cache cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_case(model: str, dtype: torch.dtype, flush: torch.Tensor) -> dict:
    cfg = get_config(model)
    B, S, H, Hkv, D = len(POSITIONS), 1024, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q = torch.randn((B, H, D), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=dtype)
    pos = torch.tensor(POSITIONS, dtype=torch.int32, device="cuda")
    k_nan, v_nan = k.clone(), v.clone()
    for b, p in enumerate(POSITIONS):
        k_nan[b, p + 1:] = float("nan")
        v_nan[b, p + 1:] = float("nan")

    out = k1.decode_gqa_attention(q, k_nan, v_nan, pos)
    torch.cuda.synchronize()
    ref = k1.decode_gqa_attention_ref(q, k_nan, v_nan, pos)
    if not torch.isfinite(out).all():
        fail(f"K1 {model} {dtype}: non-finite output (rows past a position were read)")
    err = (out.float() - ref.float()).abs().max().item()
    if err > TOL[dtype]:
        fail(f"K1 {model} {dtype}: max abs error {err} > {TOL[dtype]}")

    kernel_ms = time_ms(lambda: k1.decode_gqa_attention(q, k_nan, v_nan, pos), flush)
    plain_ms = time_ms(lambda: k1.decode_gqa_attention_ref(q, k_nan, v_nan, pos), flush)
    # Yardstick only: one library call of the same function (the port
    # never calls it). NaN rows would poison its pv product, so it gets
    # the clean cache.
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None].long())[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    try:
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush)
    except TypeError as e:  # a torch without enable_gqa has no one-call form
        print(f"library call unavailable: {e}", flush=True)
        library_ms = None

    item = q.element_size()
    rows = sum(p + 1 for p in POSITIONS)
    bytes_moved = 2 * q.numel() * item + pos.numel() * 4 + rows * Hkv * D * 2 * item
    ops = rows * H * D * 4          # q.k and p.v, multiply-add each
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    case = dict(model=model, dtype=str(dtype).removeprefix("torch."),
                shape=dict(B=B, H=H, Hkv=Hkv, D=D, S=S), max_abs_err=err,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print("K1 case " + json.dumps(case), flush=True)
    return case


# -- phase 4 ---------------------------------------------------------------

def reference_check() -> None:
    """Small model, f32: the card's forward (kernel at T == 1) against the
    CPU's (plain path) on identical weights, a prefill then 3 decode
    steps at ragged positions; logits within 1e-4 (summation order only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("test-tiny")
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                   dtype=torch.float32)
    rng = np.random.default_rng(7)
    B, T, S = 3, 12, 64
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, B)))
    starts = torch.tensor([T, T + 5, T + 9], dtype=torch.int32)
    logits = {}
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        ck, cv = llama.init_kv_cache(cfg, B, S, dev, dtype=torch.float32)
        pos = torch.arange(T, dtype=torch.int32).expand(B, T).to(dev)
        lg, ck, cv = llama.forward(params, cfg, prompt.to(dev), pos, ck, cv,
                                   torch.zeros(B, dtype=torch.int32, device=dev))
        out = [lg[:, -1].cpu()]
        for i in range(3):
            p = (starts + i).to(dev)
            lg, ck, cv = llama.forward(params, cfg, steps[i][:, None].to(dev),
                                       p[:, None], ck, cv, p)
            out.append(lg[:, 0].cpu())
        logits[dev] = torch.stack(out)
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    if not torch.isfinite(logits["cuda"]).all() or err > 1e-4:
        fail(f"card forward disagrees with the CPU reference: max abs err {err}")
    print(f"reference check: test-tiny f32 card vs CPU logits max abs err {err}",
          flush=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def wall_decode_ms(metrics: dict, steps: int) -> float:
    """Host wall per decode step: enqueueing plus waiting on tokens. With
    the device ahead of the host, dispatch dominates; behind, sync does."""
    return (metrics["decode_dispatch_s"] + metrics["decode_sync_s"]) / max(steps, 1) * 1e3


def serve(card: str) -> dict:
    cfg = get_config("llama3-8b")
    ecfg = EngineConfig()
    t0 = time.monotonic()
    engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    t0 = time.monotonic()
    engine.warmup()
    warmup_s = time.monotonic() - t0
    print(f"engine llama3-8b bf16 L={cfg.num_layers}: init {init_s:.1f}s "
          f"warmup {warmup_s:.1f}s", flush=True)

    rng = np.random.default_rng(42)
    lengths = [17, 900, 64, 333, 128, 511, 45, 700, 250, 31, 600, 100]
    greedy = SamplingParams(temperature=0.0, max_tokens=48)
    sampled = dict(temperature=0.7, top_p=0.9, top_k=40)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
        max_tokens = 32 + (i * 7) % 33
        sp = (SamplingParams(temperature=0.0, max_tokens=max_tokens) if i % 2 == 0
              else SamplingParams(max_tokens=max_tokens, seed=100 + i, **sampled))
        reqs.append((prompt, sp))
    # One greedy prompt submitted three times: at the start, mid-run and last.
    for i in (0, 5, len(reqs) - 1):
        reqs[i] = (reqs[0][0], greedy)

    engine.start()
    k1.decode_gqa_attention.launches = 0     # counts start here
    steps0 = engine.metrics["decode_steps"]
    t_start = time.monotonic()
    results = [None] * len(reqs)

    def consume(i, handle, t_submit):
        toks, times = [], []
        for ev in handle.events(timeout=600):
            if ev.token_id is not None:
                toks.append(ev.token_id)
                times.append(time.monotonic())
            if ev.is_final:
                results[i] = (toks, ev, t_submit, times)

    threads = []
    for i, (prompt, sp) in enumerate(reqs):
        t_submit = time.monotonic()
        h = engine.submit(prompt, sp)
        th = threading.Thread(target=consume, args=(i, h, t_submit))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t_start
    engine.stop()
    torch.cuda.synchronize()
    launches = k1.decode_gqa_attention.launches
    decode_steps = engine.metrics["decode_steps"] - steps0

    for i, r in enumerate(results):
        if r is None:
            fail(f"request {i} never finished")
        toks, ev, _, _ = r
        if ev.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP) or ev.error:
            fail(f"request {i} ended {ev.finish_reason} error={ev.error}")
        if ev.num_generated_tokens != len(toks):
            fail(f"request {i}: {ev.num_generated_tokens} counted, {len(toks)} streamed")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {i}: token id out of range")
    if not (results[0][0] == results[5][0] == results[-1][0]):
        fail("the repeated greedy prompt gave different tokens")
    expected = cfg.num_layers * decode_steps
    if launches != expected or launches == 0:
        fail(f"K1 launched {launches} times on the main path, expected "
             f"{cfg.num_layers} x {decode_steps} decode steps = {expected}")

    ttft = [r[3][0] - r[2] for r in results]
    per_req = [(len(r[3]) - 1) / (r[3][-1] - r[3][0]) for r in results if len(r[3]) > 1]
    generated = sum(len(r[0]) for r in results)
    summary = dict(
        card=card, requests=len(results), generated_tokens=generated,
        decode_steps=decode_steps, k1_launches=launches,
        ttft_p50_s=statistics.median(ttft), wall_s=wall,
        tokens_per_s=generated / wall,
        per_request_decode_tokens_per_s_p50=statistics.median(per_req),
        decode_step_ms=wall_decode_ms(engine.metrics, decode_steps),
        decode_dispatch_s=engine.metrics["decode_dispatch_s"],
        decode_sync_s=engine.metrics["decode_sync_s"],
        prefill_dispatch_s=engine.metrics["prefill_dispatch_s"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        init_s=init_s, warmup_s=warmup_s,
    )
    print("engine " + json.dumps(summary), flush=True)
    return dict(launches=launches, engine=engine)


def decode_profile(engine, card: str) -> None:
    """A traced window of synchronous decode (8 greedy requests, stepped
    inline after serving): the device's busy share of the wall and the
    kernels that take its time. Reads "not measured" where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(9)
    handles = [engine.submit([int(t) for t in rng.integers(0, engine.model_cfg.vocab_size, 40)],
                             SamplingParams(temperature=0.0, max_tokens=24))
               for _ in range(engine.cfg.num_slots)]
    engine.step()                       # place one request outside the window
    steps0 = engine.metrics["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        while engine.step():
            pass
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    for h in handles:
        h.collect_tokens(timeout=60)
    # Device-side entries only: the host ops that launched them carry the
    # same device time again.
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print("decode profile " + json.dumps(dict(
        card=card, wall_ms=wall_ms,
        decode_steps=engine.metrics["decode_steps"] - steps0,
        device_kernels=sum(e.count for e in kern),
        device_busy_ms=busy_ms if kern else "not measured",
        device_busy_share=busy_ms / wall_ms if kern else "not measured",
        top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    )), flush=True)


def main() -> None:
    card = device_line()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    print(f"device {name} x{torch.cuda.device_count()} | {card}", flush=True)

    t0 = time.monotonic()
    built = kernels.build_all()
    print(f"kernel build {time.monotonic() - t0:.2f}s {json.dumps(built)}", flush=True)
    for src in built:
        print(f"ptxas {src}: {ptxas_summary(src)}", flush=True)

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    cases = [kernel_case(m, dt, flush) for m in ("llama3-8b", "llama3-1b")
             for dt in (torch.bfloat16, torch.float32)]
    del flush
    reference_check()

    main_path = serve(card)
    decode_profile(main_path["engine"], card)

    main_case = cases[0]   # llama3-8b bf16: the engine's shape
    entry = dict(
        name="decode_gqa_attention", route="cuda",
        source="omnia_tpu_torch/csrc/decode_attention.cu",
        replaces="omnia_tpu/ops/decode_attention.py:35",
        launches=main_path["launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        max_err=max(c["max_abs_err"] for c in cases), kernel_ms=main_case["ms"],
    )
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
