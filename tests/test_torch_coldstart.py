"""The port's cold-start layer held against the JAX package on the CPU.

The tracker, the warmup manifest and its bookkeeping transaction are
copies: one scripted clock and one call sequence give the JAX copy's
snapshots, and either package reads the other's manifest files. Warmup
runs a (family, key, task) inventory in the order the serial warmup
always ran it, whatever ``warmup_threads`` is, to the same restored
state and tokens. The manifest's key
follows what shapes the programs and ignores host-side knobs;
``expected_param_bytes`` equals the JAX loader's; a checkpoint loader
streams under the weights_load phase with byte progress while the
param-free tasks run beside it; and ``build_engine(coldstart=)`` records
every phase. A task's failure is raised, never dropped."""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine import coldstart as jcs
from omnia_tpu.models import checkpoint as jck
from omnia_tpu.models import get_config as jget_config
from omnia_tpu_torch import kernels
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.engine import coldstart as tcs
from omnia_tpu_torch.engine import warmup as twarmup
from omnia_tpu_torch.engine.flight import to_chrome_trace
from omnia_tpu_torch.models import checkpoint as tck
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine

BASE = dict(num_slots=2, max_seq=128, prefill_buckets=(32, 64), dtype="float32",
            max_sessions=4)
LLAMA3_8B_BF16_BYTES = 16_060_522_496


@pytest.fixture(autouse=True)
def manifest_dir(tmp_path, monkeypatch):
    """Every engine here keeps its manifests in the test's own directory."""
    d = tmp_path / "manifests"
    monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(d))
    return d


def _engine(**over) -> InferenceEngine:
    return InferenceEngine(get_config("test-tiny"), EngineConfig(**dict(BASE, **over)),
                           seed=3, device="cpu")


# ---------------------------------------------------------------------------
# The tracker and the manifest
# ---------------------------------------------------------------------------


def test_phases_equal_jax():
    assert tcs.PHASES == jcs.PHASES and tcs.PHASE_CODES == jcs.PHASE_CODES


def _tracker_script(cs, t: list) -> list:
    """Overlapping phases, weights progress (a late callback included),
    a re-warmup, manifest books and readiness: a snapshot after each."""
    snaps = [cs.snapshot()]
    cs.begin_phase("backend_init")
    t[0] += 0.5
    snaps.append((cs.end_phase("backend_init"), cs.current_phase()))
    cs.begin_phase("weights_load")
    t[0] += 1.0
    cs.begin_phase("warmup_compile")
    cs.set_programs_total(4)
    cs.note_weights(100, 1000)
    cs.note_weights(50, 1000)
    snaps.append(cs.snapshot())
    t[0] += 2.0
    snaps.append((cs.note_program(), cs.note_program(3), cs.end_phase("weights_load")))
    snaps.append(cs.snapshot())
    cs.note_weights(1000, 1000)
    cs.end_phase("warmup_compile")
    cs.note_manifest(3, 1)
    cs.begin_phase("warmup_restore")
    t[0] += 0.25
    cs.end_phase("warmup_restore")
    cs.mark_ready()
    snaps.append(cs.snapshot())
    cs.begin_phase("warmup_compile")                  # a second warmup un-readies
    cs.set_programs_total(2)
    snaps.append((cs.current_phase(), cs.note_program(), cs.phase_seconds()))
    with pytest.raises(ValueError):
        cs.begin_phase("nope")
    snaps.append(cs.end_phase("never_begun"))
    return snaps


def test_tracker_equals_jax_on_a_scripted_clock():
    tj, tt = [10.0], [10.0]
    assert _tracker_script(tcs.ColdStartTracker(clock=lambda: tt[0]), tt) == \
        _tracker_script(jcs.ColdStartTracker(clock=lambda: tj[0]), tj)


@pytest.mark.parametrize("payload", [{"model": {"layers": 2}, "engine": {"max_seq": 128}},
                                     {"model": {"x": (1, 2)}, "backend": "cpu"}])
def test_manifest_key_equals_jax(payload):
    assert tcs.WarmupManifest.manifest_key(payload) == jcs.WarmupManifest.manifest_key(payload)


def test_manifest_files_and_books_interchange_with_jax(tmp_path):
    """Each package reads what the other stored; the bookkeeping
    transaction counts the same hits and misses over one sequence."""
    d = str(tmp_path)
    assert tcs.WarmupManifest.store(d, "k", ["decode:chunk8", "prefill:bucket64"])
    assert jcs.WarmupManifest.load(d, "k") == ["decode:chunk8", "prefill:bucket64"]
    assert jcs.WarmupManifest.store(d, "k", ["session:rows64"])
    assert tcs.WarmupManifest.load(d, "k") == ["decode:chunk8", "prefill:bucket64",
                                               "session:rows64"]
    books = []
    for mod in (tcs, jcs):
        sub = os.path.join(d, mod.__name__)
        runs = []
        for keys in (["a:1", "b:2"], ["a:1", "b:2", "c:3"], ["c:3"]):
            cs = mod.ColdStartTracker()
            runs.append((mod.manifest_bookkeeping(sub, "k", keys, cs), cs.snapshot()))
        runs.append(mod.manifest_bookkeeping(None, "k", ["a:1"], mod.ColdStartTracker()))
        books.append(runs)
    assert books[0] == books[1]
    blocked = tmp_path / "a_file"
    blocked.write_text("x")
    assert tcs.WarmupManifest.store(str(blocked), "k", ["a:b"]) is False
    (tmp_path / f"warmup_manifest_bad.json").write_text("{not json")
    assert tcs.WarmupManifest.load(d, "bad") is None


def test_manifest_dir_reads_the_override_then_the_build_cache(tmp_path, monkeypatch):
    """The override first; without it the kernel build directory when it
    is writable (also what compile_cache_enabled reports), else None."""
    monkeypatch.setenv("OMNIA_WARMUP_MANIFEST_DIR", str(tmp_path / "override"))
    assert tcs.manifest_dir() == str(tmp_path / "override")
    monkeypatch.delenv("OMNIA_WARMUP_MANIFEST_DIR")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    assert tcs.manifest_dir() == tcs.build_cache_dir() == str(tmp_path / "build")
    assert _engine().metrics["compile_cache_enabled"] == 1
    monkeypatch.setattr(tcs.os, "access", lambda path, mode: False)
    assert tcs.manifest_dir() is None and tcs.build_cache_dir() is None
    assert _engine().metrics["compile_cache_enabled"] == 0


# ---------------------------------------------------------------------------
# Warmup
# ---------------------------------------------------------------------------


def test_serial_warmup_keeps_its_task_order():
    """warmup_threads=0 runs the inventory in the order warmup always ran
    it: each prefill bucket, an extend piece per bucket and of one token,
    an offload and restore per restore bucket, each decode chunk, the
    verify window, each mixed step; the page copy on a paged engine. The
    CPU has no kernel to build; the card adds it first."""
    eng = _engine(prefill_chunk_tokens=32, spec_decode=2, kv_pages=17, kv_page_tokens=16)
    order = [f"{f}:{k}" for f, k, _ in eng._warmup_tasks()]
    assert order == [
        "prefill:bucket32", "prefill:bucket64",
        "extend:piece1", "extend:piece32", "extend:piece64",
        "session:rows32", "session:rows64", "session:rows128",
        "decode:chunk8", "decode:chunk1",
        "spec:verify",
        "mixed:bucket1", "mixed:bucket32",
        "pages:copy",
    ]
    ran = []

    def recorded(name, fn):
        def run(st):
            ran.append((name, st.ck is eng._ck))
            fn(st)
        return run

    tasks = [(f, k, recorded(f"{f}:{k}", fn)) for f, k, fn in eng._warmup_tasks()]
    eng._run_warmup_serial(tasks)
    assert ran == [(name, True) for name in order]   # in order, on the engine's caches


def test_default_engine_inventory_and_param_free_families():
    eng = _engine()
    fams = [f for f, _, _ in eng._warmup_tasks()]
    assert fams == ["prefill"] * 2 + ["extend"] * 3 + ["session"] * 3 + ["decode"] * 2
    paramfree = eng._warmup_tasks(families=twarmup.PARAMFREE_FAMILIES)
    assert [f for f, _, _ in paramfree] == ["session"] * 3


def _state(eng) -> list:
    tensors = [eng._tokens, eng._positions, eng._active, eng._budget, eng._key_data,
               eng._temp, eng._top_p, eng._top_k]
    for c in (eng._ck, eng._cv):
        if hasattr(c, "table"):
            tensors.append(c.table)
            c = c.pool
        tensors += [c.q, c.s] if hasattr(c, "q") else [c]
    return [t.clone() for t in tensors]


@pytest.mark.parametrize("fields", [dict(), dict(kv_quant="int8", kv_pages=17,
                                                 kv_page_tokens=16, prefill_chunk_tokens=32)])
def test_parallel_warmup_leaves_the_serial_state_and_tokens(fields):
    """warmup_threads=2 runs the same inventory in order on the engine's
    caches: the program count is complete, the restored state equals
    warmup_threads=0's, greedy and seeded sampled tokens are the same,
    and no warmup thread is left behind."""
    outs = []
    before = set(threading.enumerate())
    for threads in (0, 2):
        eng = _engine(warmup_threads=threads, **fields)
        eng.warmup()
        m = eng.metrics
        assert m["warmup_programs_done"] == m["warmup_programs_total"] > 0
        state = _state(eng)
        toks = [eng.generate(list(range(1, 40)), SamplingParams(temperature=0.0,
                                                                max_tokens=10))[0],
                eng.generate([5, 6, 7], SamplingParams(temperature=0.9, top_p=0.9, top_k=20,
                                                       max_tokens=10, seed=11))[0]]
        outs.append((state, toks))
    for a, b in zip(outs[0][0], outs[1][0], strict=True):
        assert torch.equal(a, b)
    assert outs[0][1] == outs[1][1]
    assert not {th for th in set(threading.enumerate()) - before
                if th.name.startswith("omnia-warmup")}


@pytest.mark.parametrize("threads", [0, 2])
def test_a_failing_task_raises_out_of_warmup(threads):
    """No fallback: a task's exception (as a failed kernel build would
    raise it) leaves warmup(), whatever warmup_threads is."""
    eng = _engine(warmup_threads=threads)

    def broken(*_a, **_k):
        raise kernels.KernelBuildError("injected build failure")

    eng._decode_fns[1] = broken
    with pytest.raises(kernels.KernelBuildError, match="injected"):
        eng.warmup()


def _build_listing():
    """The package's build cache (kernels.BUILD_DIR): names and times."""
    if not kernels.BUILD_DIR.is_dir():
        return None
    return sorted((p.name, p.stat().st_mtime_ns) for p in kernels.BUILD_DIR.iterdir())


def test_a_warmed_engine_leaves_the_build_cache_alone(manifest_dir):
    """Under the override a warmed engine writes its manifest there and
    leaves the package's build cache (kernels.BUILD_DIR) as it was."""
    before = _build_listing()
    eng = _engine(max_seq=96)
    eng.warmup()
    assert eng.metrics["warmup_programs_done"] == eng.metrics["warmup_programs_total"] > 0
    assert [p.name for p in manifest_dir.iterdir()] == [
        f"warmup_manifest_{eng._warmup_manifest_key()}.json"]
    assert _build_listing() == before


def test_a_rank_warmed_in_a_spawn_leaves_the_build_cache_alone(tmp_path, monkeypatch):
    """The environment every spawn of ``test_torch_nccl_cuda.py`` passes
    (``torch_ring_workers.rank_env``) reaches a spawned rank: two gloo
    ranks warm a tp = 2 engine, and the manifests land in the spawn's
    directory and not in the build cache. The test's own override is
    removed first, so only the spawn's environment can direct the ranks."""
    import torch_ring_workers as ring_workers
    from omnia_tpu_torch.parallel.launch import spawn_ranks

    monkeypatch.delenv("OMNIA_WARMUP_MANIFEST_DIR")
    before = _build_listing()
    d = tmp_path / "ranks"
    got = spawn_ranks(ring_workers.warm_job, 2, backend="gloo", env=ring_workers.rank_env(d),
                      timeout_s=300)
    assert [g["manifest_dir"] for g in got] == [str(d)] * 2
    assert all(g["programs"] > 0 for g in got)
    assert [p.name for p in d.iterdir()] and all(
        p.name.startswith("warmup_manifest_") for p in d.iterdir())
    assert _build_listing() == before


def test_manifest_keys_follow_the_shapes_not_the_host_knobs():
    """A second engine of the same config hits every program; the model,
    the bucket set, kv_quant, kv_pages and max_seq each re-key; the
    host-side knobs do not."""
    e1 = _engine()
    e1.warmup()
    total = e1.metrics["warmup_programs_total"]
    assert e1.metrics["warmup_manifest_misses"] == total > 0
    e2 = _engine()
    e2.warmup()
    assert (e2.metrics["warmup_manifest_hits"], e2.metrics["warmup_manifest_misses"]) == \
        (total, 0)
    keys = {e1._warmup_manifest_key()}
    for over in (dict(prefill_buckets=(32,)), dict(kv_quant="int8"),
                 dict(kv_pages=9, kv_page_tokens=16), dict(max_seq=64)):
        keys.add(_engine(**over)._warmup_manifest_key())
    model = dataclasses.replace(get_config("test-tiny"), num_layers=3)
    keys.add(InferenceEngine(model, EngineConfig(**BASE), seed=3,
                             device="cpu")._warmup_manifest_key())
    assert len(keys) == 6
    assert _engine(warmup_threads=3, flight_events=64, max_queue=8,
                   watchdog_s=5.0)._warmup_manifest_key() == e1._warmup_manifest_key()


def test_warmup_progress_metrics_and_init_events():
    """After warmup: phase ready, every program done, the manifest books
    mirrored; the flight ring holds the init phases with their seconds."""
    eng = _engine(flight_events=128)
    eng.warmup()
    m = eng.metrics
    assert m["warmup_phase"] == tcs.PHASE_CODES["ready"]
    assert m["warmup_programs_done"] == m["warmup_programs_total"] == 10
    kinds = [e.kind for e in eng._flight.events()]
    assert [k for k in kinds if k != "backend_init"] == ["warmup_compile", "warmup_restore"]
    ev = eng._flight.events("warmup_compile")[0]
    assert ev.attrs["programs"] == 10 and ev.attrs["threads"] == 0 and ev.attrs["seconds"] > 0
    names = {e["name"] for e in to_chrome_trace(eng._flight.events())["traceEvents"]}
    assert {"warmup_compile", "warmup_restore"} <= names
    assert eng._coldstart.snapshot()["phase"] == "ready"


# ---------------------------------------------------------------------------
# Weights: bytes, progress, overlap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["test-tiny", "llama3-8b", "llama3-70b", "mixtral-8x7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_expected_param_bytes_equal_jax(model, dtype):
    t = tck.expected_param_bytes(get_config(model), getattr(torch, dtype))
    assert t == jck.expected_param_bytes(jget_config(model), getattr(jnp, dtype))
    if (model, dtype) == ("llama3-8b", "bfloat16"):
        assert t == LLAMA3_8B_BF16_BYTES


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = get_config("test-tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               dtype=torch.float32)
    path = str(tmp_path_factory.mktemp("ckpt"))
    tck.save_params(params, cfg, path)
    return path, cfg, params


def test_loader_streams_with_progress_beside_the_param_free_tasks(checkpoint, monkeypatch):
    """A loader callable streams under weights_load, its byte progress
    reaching expected_param_bytes; with warmup_threads > 0 the param-free
    tasks run on a side thread inside the weights_load span, and the
    engine serves what a preloaded one serves."""
    path, cfg, params = checkpoint
    spans, feed = {}, []
    paramfree = InferenceEngine._warmup_paramfree

    def timed_paramfree(self):
        spans["thread"] = threading.current_thread().name
        spans["start"] = time.monotonic()
        paramfree(self)
        spans["end"] = time.monotonic()

    monkeypatch.setattr(InferenceEngine, "_warmup_paramfree", timed_paramfree)

    def loader(progress_cb=None):
        def meter(loaded, total):
            feed.append((loaded, total))
            progress_cb(loaded, total)

        return tck.load_params(path, cfg, dtype=torch.float32, device="cpu", progress_cb=meter)

    eng = InferenceEngine(cfg, EngineConfig(**BASE, warmup_threads=2, flight_events=64),
                          params=loader, seed=3, device="cpu")
    want = tck.expected_param_bytes(cfg, torch.float32)
    assert feed[-1] == (want, want)
    assert eng.metrics["weights_bytes_loaded"] == eng.metrics["weights_bytes_total"] == want
    evs = {e.kind: e for e in eng._flight.events()}
    assert evs["weights_load"].attrs["bytes"] == want
    load = evs["weights_load"]
    # The side thread ran inside the weights_load span, beside the loader.
    assert spans["thread"] == "omnia-warmup-overlap"
    assert load.mono - load.attrs["seconds"] <= spans["start"] <= spans["end"] <= load.mono
    eng.warmup()
    compile_ev = eng._flight.events("warmup_compile")[0]
    # warmup_compile is warmup()'s own span, after the load, as in JAX.
    assert compile_ev.mono - compile_ev.attrs["seconds"] >= evs["weights_load"].mono
    ref = InferenceEngine(cfg, EngineConfig(**BASE), params=params, seed=3, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    assert eng.generate([5, 6, 7], sp)[0] == ref.generate([5, 6, 7], sp)[0]


def test_serial_start_runs_no_overlap(checkpoint, monkeypatch):
    """warmup_threads=0: the loader runs alone, nothing on a side thread."""
    path, cfg, _ = checkpoint
    monkeypatch.setattr(InferenceEngine, "_warmup_paramfree",
                        lambda self: pytest.fail("no overlap at warmup_threads=0"))
    eng = InferenceEngine(cfg, EngineConfig(**BASE), seed=3, device="cpu",
                          params=lambda progress_cb=None: tck.load_params(
                              path, cfg, dtype=torch.float32, device="cpu",
                              progress_cb=progress_cb))
    assert eng.metrics["weights_bytes_loaded"] == tck.expected_param_bytes(cfg, torch.float32)


def test_an_overlap_failure_raises_out_of_construction(checkpoint, monkeypatch):
    path, cfg, _ = checkpoint

    def broken(self):
        raise kernels.KernelBuildError("injected build failure")

    monkeypatch.setattr(InferenceEngine, "_warmup_paramfree", broken)
    with pytest.raises(kernels.KernelBuildError, match="injected"):
        InferenceEngine(cfg, EngineConfig(**BASE, warmup_threads=2), seed=3, device="cpu",
                        params=lambda: tck.load_params(path, cfg, dtype=torch.float32,
                                                       device="cpu"))


@pytest.mark.parametrize("tracker_pkg", [tcs, jcs])
def test_build_engine_records_the_phases(checkpoint, tracker_pkg):
    """The runtime's bring-up through build_engine: backend_init begun by
    the caller and closed by the engine, weights_load with the bytes,
    warmup_compile and warmup_restore, then ready; either package's
    tracker serves."""
    path, cfg, _ = checkpoint
    tracker = tracker_pkg.ColdStartTracker()
    tracker.begin_phase("backend_init")
    eng = build_engine(ProviderSpec(name="c", model="test-tiny", options=dict(
        checkpoint_path=path, dtype="float32", num_slots=2, max_seq=128,
        prefill_buckets=[32, 64], warmup_threads=2, flight_events=64)),
        device="cpu", coldstart=tracker)
    assert tracker.current_phase() == "weights_load"     # the last phase to end
    eng.warmup()
    snap = tracker.snapshot()
    assert snap["phase"] == "ready"
    assert set(snap["phases_s"]) == {"backend_init", "weights_load", "warmup_compile",
                                     "warmup_restore"}
    want = tck.expected_param_bytes(cfg, torch.float32)
    assert snap["weights_bytes_loaded"] == snap["weights_bytes_total"] == want
    assert snap["programs_done"] == snap["programs_total"] == \
        eng.metrics["warmup_programs_total"]
    assert eng.metrics["warmup_phase"] == tcs.PHASE_CODES["ready"]
    assert [e.kind for e in eng._flight.events()] == [
        "backend_init", "weights_load", "warmup_compile", "warmup_restore"]
    assert np.isfinite([e.attrs["seconds"] for e in eng._flight.events()]).all()
