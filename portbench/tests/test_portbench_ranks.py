"""A cell whose engine asks for tp runs one rank per device, driven in
lockstep, from its files alone: here two gloo ranks on the CPU (on the
card, one rank per card over NCCL). Each rank reports what it loaded of
JAX or the JAX package once the window has closed, and a run whose
ranks loaded any of it is refused."""

import json

from portbench import run, spec
from portbench.tests import tiny


def test_a_tp2_cell_runs_over_two_ranks(tmp_path):
    root = tiny.make_root(tmp_path)
    # A light load of short answers: two lockstep ranks on a busy CPU
    # finish few requests, and the check wants greedy and sampled ones.
    mix = dict(tiny.MIX, rate_per_s=4.0, engine=dict(tiny.MIX["engine"], tp=2),
               output={"dist": "uniform", "min": 4, "max": 8})
    (root / "portbench" / "traffic" / "tiny_tp2.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.tp2", "config": "tiny-dense",
                               "traffic": "tiny_tp2", "chips": 4, "why": "tiny"})
    # A metric reader that rank 0 runs plants a module named "flax" there.
    (root / "portbench" / "metrics" / "plants_flax.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        "    sys.modules.setdefault('flax', types.ModuleType('flax'))\n    return None\n")
    bench["end_to_end"].append({"name": "plants_flax", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.tp2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(root, "tiny.tp2")
    result = run.run_cell(cell, "tiny.tp2", 77, 5.0, False, "cpu", root=root)
    assert result["correct"], result["checked"]
    assert result["device"]["count"] == 2
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "plants_flax" not in result["metrics"]
    assert result["forbidden_modules"] == ["flax"]
    assert "flax" in run.forbidden_in(result)
    assert list(result)[-1] == "checked"


def test_a_run_whose_ranks_loaded_jax_prints_no_result(monkeypatch, capfd):
    """main refuses, with exit code 3 and no result line, a run whose
    spawned ranks loaded what the parent process did not."""
    import faulthandler

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"forbidden_modules": ["omnia_tpu"],
                                                          "checked": {}})
    try:
        code = run.main(["--workload", "mistral7b.chat", "--seed", "1", "--seconds", "1"])
    finally:
        faulthandler.cancel_dump_traceback_later()
    assert code == 3
    out, err = capfd.readouterr()
    assert out == "" and "omnia_tpu" in err
