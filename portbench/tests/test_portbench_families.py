"""An architecture is a family file found by the configuration's
``model_type``: added as new files in a copy of the benchmark (the
family, its reference and a configuration), it runs a cell with no edit
to any file that is there, and its reference is what decides
``correct``. The weights follow the family's leaves, stacks of any
depth under any prefix."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import families, spec, weights
from portbench.tests import tiny

# Mixtral's block at the tiny MoE's sizes, its experts spelled with
# DeepSeek's key names.
TOY = {k: v for k, v in tiny.MOE.items() if k not in ("num_local_experts", "intermediate_size")}
TOY.update(name="tiny-toy", model_type="toy_moe", n_routed_experts=8, moe_intermediate_size=128)

TOY_FAMILY = '''"""A toy architecture: Mixtral's block under DeepSeek's key names."""

from portbench import weights
from portbench.families import mistral
from portbench.reference import toy_moe as ref


def _mixtral(cfg):
    return dict(cfg, num_local_experts=cfg["n_routed_experts"],
                intermediate_size=cfg["moe_intermediate_size"])


def model_config(cfg):
    return mistral.model_config(_mixtral(cfg))


def leaves(cfg):
    return mistral.leaves(_mixtral(cfg))


def matmul_params_per_token(cfg):
    return mistral.matmul_params_per_token(_mixtral(cfg))


def head_params(cfg):
    return mistral.head_params(_mixtral(cfg))


def prefill_flops(cfg, n):
    return mistral.prefill_flops(_mixtral(cfg), n)


def decode_flops(cfg, position):
    return mistral.decode_flops(_mixtral(cfg), position)


def decode_attention_bytes(cfg, position, itemsize=2):
    return mistral.decode_attention_bytes(_mixtral(cfg), position, itemsize)


def reference_logits(cfg, seed, sequences, wanted, precision, device, dtype):
    return ref.logits_at(lambda i: weights.layer(cfg, seed, i, device, dtype),
                         weights.globals_(cfg, seed, device, dtype), cfg, sequences, wanted,
                         precision, device)
'''

# The toy's reference reads its own keys. ``TOP_K`` is the experts it
# routes a token to: None, as many as the configuration says. Routed to
# one where the program takes two, it departs from the program in a way
# that the toy's limits catch: over five seeds on the CPU a sound run's
# mean_gap read at most 0.033 and its request_p25_gap 0; over six, the
# top-1 reference's 0.52-0.74 and 0.22-0.69, against limits of 0.1 each.
# (A doubled rope_theta read 0.046-0.23, and passed on two seeds of five.)
TOY_REFERENCE = '''"""The toy's plain reference: Mixtral's, under DeepSeek's key names."""

from . import model

TOP_K = {top_k}


def logits_at(layer, top, cfg, sequences, wanted, precision, device):
    mixtral = dict(cfg, num_local_experts=cfg["n_routed_experts"],
                   intermediate_size=cfg["moe_intermediate_size"],
                   num_experts_per_tok=TOP_K or cfg["num_experts_per_tok"])
    return model.logits_at(layer, top, mixtral, sequences, wanted, precision, device)
'''


def _toy_root(tmp_path, top_k=None):
    """A copy of the benchmark with the toy architecture added as new
    files, and (the files that were there before it, their bytes)."""
    root = tiny.make_root(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    (pb / "families" / "toy_moe.py").write_text(TOY_FAMILY)
    (pb / "reference" / "toy_moe.py").write_text(TOY_REFERENCE.format(top_k=top_k))
    (pb / "configs" / "tiny-toy.json").write_text(json.dumps(TOY))
    (pb / "traffic" / "tiny_tp2.json").write_text(
        json.dumps(dict(tiny.CLOSED, engine=dict(tiny.CLOSED["engine"], tp=2))))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-toy", "source": "test widths",
                             "file": "portbench/configs/tiny-toy.json", "reduced": [],
                             "why": "tiny"})
    for name, mix in (("toy.closed", "tiny_closed"), ("toy.tp2", "tiny_tp2")):
        bench["workloads"].append({"name": name, "config": "tiny-toy", "traffic": mix,
                                   "chips": 1, "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


RUN_THE_COPY = """
import json
from pathlib import Path

import portbench
from portbench import run, spec

root = Path.cwd()
try:
    spec.load_cell(root, "toy.tp2")
    refused = None
except SystemExit as e:
    refused = str(e)
cell = spec.load_cell(root, "toy.closed")
result = run.run_cell(cell, "toy.closed", 2**31 + 5, 1.5, False, "cpu", root=root)
print(json.dumps({"package": portbench.__file__, "refused": refused,
                  "correct": result["correct"], "checked": result["checked"],
                  "answers": result["compared"]["answers"]}))
"""


def _run_the_copy(root) -> dict:
    """The toy cell run by the copy's own package, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", RUN_THE_COPY], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["package"].startswith(str(root))
    assert result["answers"] >= 1
    return result


def test_a_new_architecture_runs_from_new_files_alone(tmp_path):
    root, before = _toy_root(tmp_path)
    result = _run_the_copy(root)
    assert result["correct"], result["checked"]
    # The toy family gives no mesh_param_specs: a cell on two ranks is
    # refused, by name.
    assert "toy.tp2" in result["refused"] and "mesh_param_specs" in result["refused"]
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_the_familys_reference_decides_correct(tmp_path):
    root, _ = _toy_root(tmp_path, top_k=1)
    result = _run_the_copy(root)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checked"].values())


STACKED = {"name": "stacked", "model_type": "stacked_toy", "vocab_size": 10}


def _stacked_family():
    family = types.ModuleType("portbench.families.stacked_toy")
    family.leaves = lambda cfg: {
        "embed": (None, (10, 4), 0.02),
        "dense_layers.ln": (1, (4,), None), "dense_layers.mlp.w": (1, (4, 6), 0.02),
        "layers.ln": (3, (4,), None), "layers.mlp.w": (3, (2, 4, 5), 0.02),
        "final_norm": (None, (4,), None)}
    return family


def _at(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def test_leaves_stack_each_prefix_to_its_own_depth(monkeypatch):
    monkeypatch.setitem(sys.modules, "portbench.families.stacked_toy", _stacked_family())
    seed = 2**33 + 1
    tree = weights.draw(STACKED, seed, "cpu", torch.float32)
    assert tree["dense_layers"]["mlp"]["w"].shape == (1, 4, 6)
    assert tree["dense_layers"]["ln"].shape == (1, 4)
    assert tree["layers"]["mlp"]["w"].shape == (3, 2, 4, 5)
    assert tree["layers"]["ln"].shape == (3, 4)
    assert tree["embed"].shape == (10, 4) and tree["final_norm"].shape == (4,)
    for prefix, depth in (("dense_layers", 1), ("layers", 3)):
        for i in range(depth):
            blk = weights.block(STACKED, seed, prefix, i, "cpu", torch.float32)
            for leaf in ("ln", "mlp.w"):
                one = weights.draw_leaf(STACKED, seed, f"{prefix}.{leaf}", i, "cpu",
                                        torch.float32)
                assert torch.equal(_at(tree[prefix], leaf)[i], one)
                assert torch.equal(_at(blk, leaf), one)
    assert not torch.equal(tree["layers"]["ln"][0], tree["layers"]["ln"][1])
    assert torch.equal(weights.layer(STACKED, seed, 2, "cpu", torch.float32)["mlp"]["w"],
                       tree["layers"]["mlp"]["w"][2])
    top = weights.globals_(STACKED, seed, "cpu", torch.float32)
    assert set(top) == {"embed", "final_norm"} and torch.equal(top["embed"], tree["embed"])
    # A rank's cut is applied to each block before it is stacked.
    cut = weights.draw(STACKED, seed, "cpu", torch.float32, cut=lambda path, b: b[..., :2])
    assert cut["layers"]["mlp"]["w"].shape == (3, 2, 4, 2)
    assert torch.equal(cut["dense_layers"]["mlp"]["w"], tree["dense_layers"]["mlp"]["w"][..., :2])


def test_a_configuration_whose_family_has_no_file_stops_load_cell(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "portbench" / "configs" / "tiny-dense.json").write_text(
        json.dumps(dict(tiny.DENSE, model_type="no_such_family")))
    with pytest.raises(SystemExit) as stop:
        spec.load_cell(root, "tiny.open")
    assert str(families.path("no_such_family")) in str(stop.value)
