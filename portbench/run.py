"""Runs one benchmark cell once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m portbench`` is the same.) The cell's configuration, mix
and metrics are found by name (``spec.py``). The run draws the weights
on the card from the seed, builds the port's ``InferenceEngine`` (one
rank per card over NCCL, driven through ``LockstepEngine``, when the
mix's engine asks for tp, dp or sp), warms it up, offers the mix's load
for its lead-in and then for the measured window, and reads the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``: the flight recorder, CUDA events around the engine's program
calls, and the profiler over a span of the window). Then it frees the
program, holds a sample of the greedy answers against the plain
reference (``check.py``), and prints, as its last line, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), with ``checked`` last: each number
compared beside its limit, which also end standard error.

Without a card, or with fewer cards than the cell asks for, it prints
no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, this folder heads sys.path: put the checkout there
# instead, so that the package imports as ``portbench`` and none of its
# modules shadows a library's.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A run that has not ended by then prints every thread's stack and exits
# non-zero, well inside the 360 s a run may take.
WATCHDOG_S = 330

# The JAX package and JAX itself must not load in this process.
FORBIDDEN = ("jax", "jaxlib", "flax", "omnia_tpu")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def cache_env(root: Path) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    cache = root / "portbench" / "_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "OMNIA_WARMUP_MANIFEST_DIR": str(cache / "warmup_manifests")}


@dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``)."""

    config: dict
    mix: dict
    records: list
    t0: float
    t1: float
    setup_s: float
    counters: dict                       # engine.metrics at "open" and "close"
    num_slots: int
    spans: Optional[object] = None       # tracing.Spans (traced run)
    profile: Optional[object] = None     # tracing.Profile (traced run, card)
    trace_span: tuple = (0.0, 0.0)       # its host interval (monotonic)
    breakdowns: dict = field(default_factory=dict)   # request id → flight breakdown
    cuda: bool = False                   # a device metric reads nothing elsewhere

    def delta(self, name: str) -> float:
        return self.counters["close"][name] - self.counters["open"][name]

    def due_in_window(self) -> list:
        return [r for r in self.records if self.t0 <= r.due < self.t1]

    def tokens_between(self, a: float, b: float):
        """(record, index of the token in its answer) for every token
        pushed in [a, b)."""
        for r in self.records:
            for j, t in enumerate(r.token_times):
                if a <= t < b:
                    yield r, j


def sampling_params(mix: dict):
    from omnia_tpu_torch.engine.types import SamplingParams

    sampled = mix["sampling"]

    def make(req):
        if req.greedy:
            return SamplingParams(temperature=0.0, max_tokens=req.max_tokens)
        return SamplingParams(temperature=sampled["temperature"], top_p=sampled["top_p"],
                              top_k=sampled["top_k"], max_tokens=req.max_tokens,
                              seed=req.sample_seed)

    return make


def serve(engine, leader, cell, seed: int, seconds: float, trace: bool) -> tuple:
    """Offers the load to ``leader`` (the engine, or its lockstep facade)
    and returns what the metric readers read; ``engine`` is this rank's
    InferenceEngine."""
    import torch

    from portbench import tracing as tr
    from portbench.driver import Load
    from portbench.traffic import Traffic

    mix = cell.mix
    cuda = engine.device.type == "cuda"
    traffic = Traffic(mix, cell.config["vocab_size"], seed)
    spans = tr.Spans(engine).install() if trace else None
    profiler = tr.Profiler(cuda)
    if trace:
        profiler.prepare()
    # The profiler records the window's last trace_s seconds, so that
    # reading its buffers stalls nothing inside the window.
    trace_s = min(mix.get("trace_s", 4.0), seconds)
    counters, marks_at = {}, {}

    def on_mark(name, now):
        marks_at[name] = now
        if name in ("open", "close"):
            counters[name] = dict(engine.metrics)
            counters[name]["queue_depth"] = leader.queue_depth()
        if trace and name in ("trace_start", "close"):
            spans.hold()
            try:
                if name == "trace_start":
                    profiler.start()
                else:
                    profiler.stop()
            finally:
                spans.release()

    load = Load(leader, traffic, mix, seconds, sampling_params(mix),
                marks=((seconds - trace_s, "trace_start"),), on_mark=on_mark)
    leader.start()
    records, t0, t1 = load.run()
    leader.stop()
    if cuda:
        torch.cuda.synchronize(engine.device)
    if spans is not None:
        spans.remove()
    breakdowns = {}
    if engine._flight is not None:
        for ev in engine._flight.events("terminal"):
            bd = ev.attrs.get("breakdown")
            if bd is not None:
                breakdowns[ev.request_id] = bd
    run = Run(cell.config, mix, records, t0, t1, marks_at["open"] - T_START, counters,
              engine.cfg.num_slots, spans, profiler.read(),
              (marks_at.get("trace_start", t0), marks_at["close"]), breakdowns,
              cuda)
    return run, traffic, load.late_s, load.queue_depths


def read_metrics(run: Run, root: Path, entries: list) -> dict:
    from portbench import spec

    out = {}
    for m in entries:
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell, run: Run, traffic, seed: int, device, control: bool) -> tuple:
    """(what was compared, each number compared with its limit), with
    the program freed first."""
    import torch

    from portbench import check

    count = cell.mix["check_requests"]
    greedy = check.sample(run.records, run.t1, count, seed, greedy=True)
    sampled = check.sample(run.records, run.t1, count, seed, greedy=False)
    limits = {k: v for k, v in cell.config["check"].items() if isinstance(v, (int, float))}
    checked = {"short_answers": {"value": check.short_answers(run.records, run.t0, run.t1),
                                 "limit": 0}}
    checked.update({k: {"value": None, "limit": v} for k, v in limits.items()})
    compared = {"answers": len(greedy), "sampled_answers": len(sampled), "tokens": 0}
    if greedy or sampled:
        dtype = getattr(torch, cell.config["torch_dtype"])
        prompts = {r.index: traffic.request(r.index).prompt.tolist() for r in greedy + sampled}
        g = check.gaps(cell.config, seed, greedy, sampled, prompts, cell.mix["sampling"],
                       device, dtype, control)
        for k in limits:
            checked[k]["value"] = g["served"].get(k)
        compared["tokens"] = g["tokens_compared"]
        compared["served_gaps"] = g["served"]
        for name in ("control", "witness_bf16", "sampler_faults"):
            if name in g:
                compared[name] = g[name]
    return compared, checked


def is_correct(checked: dict) -> bool:
    """Every number compared is there and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checked.values())


def run_one(cell, seed: int, seconds: float, trace: bool, device, control: bool = False,
            rank: int = 0) -> Optional[dict]:
    """One rank's part of a run: build, warm, serve, read, free, check.
    Returns the result (rank 0), or this rank's peak memory (others)."""
    import torch

    from omnia_tpu_torch.engine.engine import InferenceEngine
    from omnia_tpu_torch.engine.multihost import LockstepEngine
    from portbench import spec, weights

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    mcfg = spec.model_config(cell.config)
    ecfg = spec.engine_config(cell.mix, flight_events=(1 << 18) if trace else 0)
    dtype = getattr(torch, cell.config["torch_dtype"])
    cut = None
    if spec.world(cell.mix) > 1:
        cut = _rank_cut(cell.config, mcfg, ecfg)
    phases = {"start": time.monotonic() - T_START}
    params = weights.draw(cell.config, seed, device, dtype, cut)
    if cuda:
        torch.cuda.synchronize(device)
    phases["weights"] = time.monotonic() - T_START
    engine = InferenceEngine(mcfg, ecfg, params=params, seed=seed % (1 << 31), device=device)
    del params
    phases["engine"] = time.monotonic() - T_START
    lockstep = LockstepEngine(engine) if spec.world(cell.mix) > 1 else None
    (lockstep or engine).warmup()
    phases["warmup"] = time.monotonic() - T_START
    if lockstep is not None and not lockstep.is_leader:
        lockstep.run_follower()
    else:
        run, traffic, late, queue = serve(engine, lockstep or engine, cell, seed, seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del engine, lockstep
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        phases["allocated_after_free_bytes"] = torch.cuda.memory_allocated(device)
    if rank != 0:
        return {"memory_peak_bytes": peak, "forbidden_modules": forbidden_modules()}
    metrics = read_metrics(run, cell.root, cell.per_layer if trace else cell.end_to_end)
    t_check = time.monotonic()
    compared, checked = judge(cell, run, traffic, seed, device, control)
    phases["check_s"] = time.monotonic() - t_check
    window = run.due_in_window()
    attempted = len(window)
    failed = sum(1 for r in window if not r.token_times or (r.ended is not None and not r.ok))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec.world(cell.mix), "memory_peak_bytes": peak}
    result = {"correct": is_correct(checked), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s()
        dev["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.top_ops(10),
                               "idle_gaps": run.profile.idle_gaps(run.spans.spans, 10)}
    result["diag"] = diagnostics(run, late, queue, phases)
    result["forbidden_modules"] = forbidden_modules()
    result["compared"] = compared
    result["checked"] = checked
    return result


def diagnostics(run: Run, late: list, queue: list, phases: dict) -> dict:
    """Numbers beside the metrics, for whoever sizes or sweeps a cell."""
    from portbench.yardstick import quantile

    window = run.due_in_window()
    ttft = [r.first - r.due for r in window if r.first is not None]
    rows = kv_rows(run)
    return {"setup_phases_s": phases,
            "kv_rows_mean": sum(rows) / len(rows) if rows else None,
            "kv_rows_peak": max(rows) if rows else None,
            "kv_rows_reserved": run.num_slots * run.mix["engine"]["max_seq"],
            "late_submit_p99_s": quantile(late, 0.99) if late else 0.0,
            "queue_depth_open": run.counters["open"]["queue_depth"],
            "queue_depth_close": run.counters["close"]["queue_depth"],
            "queue_depth_mean": (sum(queue) / len(queue)) if queue else None,
            "ttft_p50_s": quantile(ttft, 0.5) if ttft else None,
            "requests_ended_in_window": sum(1 for r in run.records
                                            if r.ended is not None and run.t0 <= r.ended < run.t1),
            "window_s": run.t1 - run.t0}


def kv_rows(run: Run, every_s: float = 0.5) -> list:
    """The cache rows that the window's requests hold, every half second:
    each request from its first token to its end holds its prompt and
    the tokens pushed so far."""
    import bisect

    out, t = [], run.t0
    while t < run.t1:
        out.append(sum(r.prompt_len + bisect.bisect_right(r.token_times, t)
                       for r in run.records
                       if r.first is not None and r.first <= t
                       and (r.ended is None or t < r.ended)))
        t += every_s
    return out


def _rank_cut(cfg, mcfg, ecfg):
    """This rank's slice of each drawn block, by the family's spec tree."""
    from omnia_tpu_torch.parallel.mesh import make_mesh
    from omnia_tpu_torch.parallel.sharding import P, shard_leaf
    from portbench import families, weights

    mesh = make_mesh(dp=ecfg.dp, sp=ecfg.sp, tp=ecfg.tp)
    specs = families.of(cfg).mesh_param_specs(mcfg, mesh)
    stacked = {path for path, (depth, _, _) in weights.leaves(cfg).items() if depth is not None}

    def cut(path, block):
        node = specs
        for key in path.split("."):
            node = node[key]
        if path in stacked:
            node = P(*tuple(node)[1:])
        return shard_leaf(block, node, mesh)

    return cut


def _rank(rank: int, root: str, workload: str, seed: int, seconds: float, trace: bool,
          control: bool, device_type: str):
    from portbench import spec

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    cell = spec.load_cell(Path(root), workload)
    if device_type == "cuda":
        from omnia_tpu_torch.parallel.distributed import rank_device
        device = rank_device()
    else:
        device = "cpu"
    return run_one(cell, seed, seconds, trace, device, control, rank)


def run_cell(cell, workload: str, seed: int, seconds: float, trace: bool, device_type: str,
             control: bool = False, root: Path = ROOT) -> dict:
    """One run of the cell: in this process on one card, else one
    spawned rank per card (NCCL on the card, gloo on the CPU). Every
    cache the program writes goes to the checkout's ``portbench/_cache``
    while the run lasts."""
    env = cache_env(root)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _run_cell(cell, workload, seed, seconds, trace, device_type, control, root)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_cell(cell, workload, seed, seconds, trace, device_type, control, root) -> dict:
    from portbench import spec

    n = spec.world(cell.mix)
    if n == 1:
        return run_one(cell, seed, seconds, trace, "cuda" if device_type == "cuda" else "cpu",
                       control)
    from omnia_tpu_torch.parallel.launch import spawn_ranks

    env = dict(cache_env(root), NCCL_GRAPH_MIXING_SUPPORT="0", USE_FLAX="0", USE_JAX="0")
    results = spawn_ranks(_rank, n, (str(root), workload, seed, seconds, trace, control,
                                     device_type),
                          backend="nccl" if device_type == "cuda" else "gloo", env=env,
                          timeout_s=340.0)
    result = results[0]
    result["device"]["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in results[1:]
                                                + [result["device"]])
    result["forbidden_modules"] = sorted({m for r in results for m in r["forbidden_modules"]})
    result["compared"] = result.pop("compared")
    result["checked"] = result.pop("checked")
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def forbidden_in(result: dict) -> list:
    """What this process, and every rank that the run spawned, loaded of
    JAX or the JAX package once the window had closed."""
    return sorted(set(forbidden_modules()) | set(result.get("forbidden_modules", ())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None,
                    help="also read the fp8 control, the bf16 witness and the planted sampler "
                         "faults over the same sample (not in benchmark runs)")
    ap.add_argument("--rate", type=float, default=None,
                    help="an open-loop mix's rate in requests/s instead of the file's (the sweep "
                         "that sets it; not in benchmark runs)")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    from portbench import spec

    cell = spec.load_cell(ROOT, args.workload)
    if args.rate is not None:
        cell.mix["rate_per_s"] = args.rate
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"have {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      control=args.control is not None)
    found = forbidden_in(result)
    if found:
        print(f"portbench: the run loaded {found}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    report(result)
    return 0


def report(result: dict) -> None:
    for name, c in result["checked"].items():
        print(f"checked {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
