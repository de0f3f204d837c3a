"""A copy of the benchmark at test sizes, for the CPU.

``make_root(dest)`` copies ``portbench/`` into ``dest`` and adds a tiny
dense and a tiny MoE configuration (Mistral's and Mixtral's shapes at
test widths), a tiny open-loop and a tiny closed-loop mix, and a
``BENCHMARK.json`` naming their cells, all as new files: the harness
finds them by name. ``python3 portbench/tests/tiny.py`` runs one tiny
cell on the CPU and prints its result line (a rehearsal: the numbers
are the CPU's and say nothing of the card).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

DENSE = {
    "name": "tiny-dense", "source": "test widths of mistral-7b-v0.3", "model_type": "mistral",
    "hidden_size": 64, "intermediate_size": 128, "max_position_embeddings": 512,
    "num_attention_heads": 4, "num_hidden_layers": 2, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "vocab_size": 256, "reduced": [],
    "check": {"widest_gap": 0.005, "sampled_outside_share": 0.25},
}
# The MoE draws its weights at 5 times the usual scale, so that its
# output moves the tokens as Mixtral's does at its own widths (at 0.02 a
# decode step that left the cache unwritten moved almost none). Router
# near-ties then flip at bfloat16 (over 16 seeds on the CPU a sound run's
# widest gap read up to 1.16, its request medians 0 and its mean gap at
# most 0.039; that decode step's at least 0.33), so it compares each
# request's lower-quartile gap and the mean gap, as the Mixtral cell does.
MOE = dict(DENSE, name="tiny-moe", model_type="mixtral", num_local_experts=8,
           num_experts_per_tok=2,
           initializer_range=0.1,
           check={"request_p25_gap": 0.1, "mean_gap": 0.1, "sampled_outside_share": 0.25})

MIX = {
    "why": "tiny", "loop": "open", "rate_per_s": 20.0,
    "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.6, "min": 8, "max": 120},
    "output": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40},
    "greedy_share": 0.5, "sampling": {"temperature": 0.7, "top_p": 0.9, "top_k": 40},
    "block": 8, "lead_in_s": 0.5, "settle_s": 30, "trace_s": 1.0, "check_requests": 4,
    "engine": {"num_slots": 4, "max_seq": 256, "prefill_buckets": [32, 64, 128],
               "decode_ring": 2, "dtype": "bfloat16"},
}
CLOSED = dict(MIX, loop="closed", clients=6)
CLOSED.pop("rate_per_s")


def make_root(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in (DENSE, MOE):
        (dest / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"portbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "tiny"})
    for name, mix in (("tiny_open", MIX), ("tiny_closed", CLOSED)):
        (dest / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = [("tiny.open", "tiny-dense", "tiny_open"), ("tiny.closed", "tiny-moe", "tiny_closed")]
    for name, cfg, mix in cells:
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c[0] for c in cells]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def main(argv: list) -> int:
    import tempfile

    sys.path.insert(0, str(REPO))
    from portbench import run, spec

    workload = argv[0] if argv else "tiny.open"
    trace = len(argv) > 1 and argv[1] == "1"
    with tempfile.TemporaryDirectory() as tmp:
        root = make_root(Path(tmp))
        cell = spec.load_cell(root, workload)
        result = run.run_cell(cell, workload, 123456789012, 3.0, trace, "cpu", root=root)
    run.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
