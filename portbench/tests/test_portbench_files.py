"""A configuration, a traffic mix and a metric are found by name: added
as new files in a copy of the benchmark, with entries in its
``BENCHMARK.json``, they run with no edit to any file that is there."""

import json

from portbench import run, spec
from portbench.tests import tiny


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    # A metric of its own: one more file and one more entry.
    (root / "portbench" / "metrics" / "prompt_tokens_p50.py").write_text(
        "from portbench.yardstick import quantile\n\n\n"
        "def read(run):\n"
        "    return quantile([r.prompt_len for r in run.due_in_window()], 0.5)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "prompt_tokens_p50", "unit": "tokens", "better": "lower",
                               "source": "host_clock", "layer": "engine",
                               "moves": "ttft_p95_s", "workloads": ["tiny.open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(root, "tiny.open")
    assert cell.config["name"] == "tiny-dense" and cell.mix["loop"] == "open"
    assert "prompt_tokens_p50" in [m["name"] for m in cell.per_layer]
    result = run.run_cell(cell, "tiny.open", 5, 1.5, True, "cpu", root=root)
    assert result["correct"], result["checked"]
    assert 8 <= result["metrics"]["prompt_tokens_p50"]["value"] <= 120
    assert result["metrics"]["prompt_tokens_p50"]["unit"] == "tokens"
    # Device metrics read nothing on the CPU, and are left out.
    assert "k1_roofline" not in result["metrics"] and "mfu.decode" not in result["metrics"]
    # Nothing that was there was edited.
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_a_closed_loop_moe_cell_runs_from_its_files(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = spec.load_cell(root, "tiny.closed")
    result = run.run_cell(cell, "tiny.closed", 2**31 + 3, 1.5, False, "cpu", root=root)
    assert result["correct"], result["checked"]
    assert set(result["metrics"]) == {"ttft_p95_s", "tpot_p95_ms", "output_tokens_per_s",
                                      "setup_s"}
    assert list(result)[-1] == "checked"
