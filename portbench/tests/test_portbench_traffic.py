"""The traffic generator: a pure function of the seed, due times drawn
up front, and the same work for every seed in another order."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import Traffic, block_gaps, block_lengths

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def mixes():
    return {p.stem: json.loads(p.read_text()) for p in sorted(TRAFFIC.glob("*.json"))}


@pytest.mark.parametrize("name", sorted(mixes()))
def test_requests_and_due_times_are_a_pure_function_of_the_seed(name):
    mix = mixes()[name]
    big = 2**31 + 12345
    a, b = Traffic(mix, 32000, big), Traffic(mix, 32000, big)
    for i in (70, 3, 0, 41):         # any order of asking gives the same request
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_tokens, ra.greedy, ra.sample_seed) == (rb.max_tokens, rb.greedy,
                                                              rb.sample_seed)
        if a.open_loop:
            assert a.due(i) == b.due(i)
    c = Traffic(mix, 32000, big + 1)
    assert not np.array_equal(a.request(5).prompt, c.request(5).prompt)


@pytest.mark.parametrize("name", sorted(mixes()))
def test_every_seed_serves_the_same_sizes_in_another_order(name):
    mix = mixes()[name]
    n = 4 * mix["block"]
    runs = [Traffic(mix, 32000, seed) for seed in (1, 2, 3)]
    prompts = [sorted(r.request(i).prompt.size for i in range(n)) for r in runs]
    outputs = [sorted(r.request(i).max_tokens for i in range(n)) for r in runs]
    assert prompts[0] == prompts[1] == prompts[2]
    assert outputs[0] == outputs[1] == outputs[2]
    orders = [[r.request(i).prompt.size for i in range(n)] for r in runs]
    assert orders[0] != orders[1]
    greedy = [sum(r.request(i).greedy for i in range(n)) for r in runs]
    assert greedy[0] == greedy[1] == round(mix["greedy_share"] * n)
    for r in runs:
        assert all(r.request(i).prompt.size + r.request(i).max_tokens <= r.max_seq - 2
                   and r.request(i).max_tokens >= 1 for i in range(n))
        if r.open_loop:
            # Due times come from the gaps alone: every block of arrivals
            # spans exactly block / rate seconds.
            span = r.due(n) - r.due(0)
            assert span == pytest.approx(n / mix["rate_per_s"])
            assert all(r.due(i + 1) > r.due(i) for i in range(n))


def test_block_quantiles_by_hand():
    lengths = block_lengths({"dist": "uniform", "min": 0, "max": 8}, 4)
    assert lengths.tolist() == [1, 3, 5, 7]
    clipped = block_lengths({"dist": "lognormal", "median": 100, "sigma": 3.0,
                             "min": 50, "max": 200}, 4)
    assert clipped.min() == 50 and clipped.max() == 200
    gaps = block_gaps(2.0, 8)
    assert gaps.mean() == pytest.approx(0.5)
    assert list(gaps) == sorted(gaps)
