"""The comparison that decides ``correct`` fails a broken program.

Each case skips the look for a card and drives the rest of a run at
test sizes on the CPU, with the timed path broken underneath: a served
token altered where the sampler produces it; a decode step that leaves
the cache as it was (its K and V rows never written); half of each
decode batch's rows misrouted, the upper half of the slots given the
lower half's logits, as a dispatch that misplaced some slots' rows
would; a sampler that leaves out its top-k filter. A sound run of each cell is correct. The control of
the card cells (the reference in fp8 in the program's place, and the
sampler's filters left out in the reference) runs on the card only: its
tests below skip here."""

import pytest
import torch

from omnia_tpu_torch.engine import programs
from omnia_tpu_torch.models import llama
from omnia_tpu_torch.ops import sampling
from portbench import run, spec
from portbench.tests import tiny


def _run(tmp_path, workload="tiny.open"):
    root = tiny.make_root(tmp_path)
    cell = spec.load_cell(root, workload)
    return run.run_cell(cell, workload, 2**31 + 99, 1.5, False, "cpu", root=root)


def _fails(result, name):
    c = result["checked"][name]
    return not result["correct"] and c["value"] > c["limit"]


def test_a_sound_run_is_correct(tmp_path):
    result = _run(tmp_path)
    assert result["correct"] and result["compared"]["tokens"] > 20
    assert result["compared"]["served_gaps"]["sampled_tokens"] > 10


def test_a_sound_moe_run_is_correct(tmp_path):
    result = _run(tmp_path, "tiny.closed")
    assert result["correct"], result["checked"]
    assert result["compared"]["answers"] >= 1 and result["compared"]["sampled_answers"] >= 1


def test_an_altered_token_is_not_correct(tmp_path, monkeypatch):
    sample = programs.sample_tokens_per_slot

    def altered(logits, *args, **kwargs):
        tok, key = sample(logits, *args, **kwargs)
        return (tok + 1) % logits.shape[-1], key

    monkeypatch.setattr(programs, "sample_tokens_per_slot", altered)
    result = _run(tmp_path)
    assert _fails(result, "widest_gap")


@pytest.mark.parametrize("workload", ["tiny.open", "tiny.closed"])
def test_a_step_that_leaves_the_cache_unchanged_is_not_correct(tmp_path, monkeypatch, workload):
    write = llama._write_kv

    def dropped(cache, new, index):
        if new.shape[1] != 1:            # prefill rows land; decode rows do not
            write(cache, new, index)

    monkeypatch.setattr(llama, "_write_kv", dropped)
    result = _run(tmp_path, workload)
    assert not result["correct"]


def test_half_the_batch_misrouted_is_not_correct(tmp_path, monkeypatch):
    """At test widths the MoE's output moves few tokens, so the rows are
    misrouted where the whole step's output meets the sampler."""
    sample = programs.sample_tokens_per_slot

    def misrouted(logits, *args, **kwargs):
        half = logits.shape[0] // 2      # a prefill's one row is left alone
        if half:
            logits = logits.clone()
            logits[half:2 * half] = logits[:half]
        return sample(logits, *args, **kwargs)

    monkeypatch.setattr(programs, "sample_tokens_per_slot", misrouted)
    result = _run(tmp_path, "tiny.closed")
    assert _fails(result, "request_p25_gap")


def test_a_sampler_that_ignores_top_k_is_not_correct(tmp_path, monkeypatch):
    thresholds = sampling._filter_thresholds

    def no_top_k(scaled, top_p, top_k):
        return thresholds(scaled, top_p, torch.zeros_like(top_k))

    monkeypatch.setattr(sampling, "_filter_thresholds", no_top_k)
    result = _run(tmp_path)
    assert _fails(result, "sampled_outside_share")


def _control_on_the_card(workload, seed):
    """On the card, at the cell's own size: the control's greedy numbers
    lie past the limits that the program keeps to, and a sampler with a
    filter left out lies past the sampled share's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's kernels run nowhere else")
    root = run.ROOT
    cell = spec.load_cell(root, workload)
    result = run.run_cell(cell, workload, seed, 25.0, False, "cuda", control=True)
    assert result["correct"], result["checked"]
    compared = result["compared"]
    for name, c in result["checked"].items():
        if name in compared["control"]:
            assert compared["control"][name] > c["limit"]
        elif name == "sampled_outside_share":
            assert max(compared["sampler_faults"].values()) > c["limit"]


@pytest.mark.cuda
def test_the_fp8_control_fails_the_chat_cell_on_the_card():
    _control_on_the_card("mistral7b.chat", 424242)


@pytest.mark.cuda
def test_the_fp8_control_fails_the_backlog_cell_on_the_card():
    _control_on_the_card("mixtral16.backlog", 434343)
