"""Whether what the timed path produced is correct.

Once the window has closed and the program is freed, a sample drawn
from the seed of the requests that finished goes to the plain reference
(``portbench/reference``): up to ``check_requests`` greedy requests and
as many sampled ones, the longest of each kind always among them. One
causal float32 pass of the configuration's family's reference
(``reference_logits``) runs over each prompt and its served tokens, the
weights drawn again from the seed block by block. The numbers that a
configuration may compare (its file names them and their limits under
``check``, set from sound runs and from the control or a planted fault):

- over the greedy requests, the gaps of the served tokens: for each
  served token, the amount by which its reference logit lies below the
  reference's best at that position. ``widest_gap`` is the largest,
  where a correct bfloat16 program only ever serves a token within
  rounding of the best (a dense model). Where rounding alone flips
  routing decisions, so that the widest gap of a sound program reads as
  far as the control's (a model with sparse experts), two numbers take
  its place: ``mean_gap``, the mean over the sample's tokens, which a
  fault that moves many tokens a little raises; and ``request_p25_gap``,
  the largest, over the greedy requests of the sample, of each request's
  lower-quartile gap. A sound request serves the reference's best, or
  within rounding of it, at more than a quarter of its positions; a
  request whose tokens a fault broke (some slots' rows lost or
  misrouted) serves it almost nowhere, so one such request in the sample
  fails the number however few of the sample it is.
- over the sampled requests, ``sampled_outside_share``: the share of the
  served tokens whose reference logit lies below the least logit that
  the mix's sampler may pick at that position (top-k, then the nucleus
  over the renormalized survivors, at the temperature), so a token that
  the filter should have removed.
- ``short_answers``: requests that ended before their ``max_tokens``
  (the traffic sets no stop ids, so every answer runs to its length),
  or ended in an error. Exact: limit 0.

The control (``--control fp8``, never in the benchmark's own runs) runs
the same reference with fp8 operands and reads, at each position of the
greedy sample, the gap of the token it puts first. The same run reads
the reference in bfloat16 the same way (a second witness of what
rounding alone does), and the share that a sampler with each of its
filters left out would serve outside the admitted set (a fault planted
in the reference put in the program's place).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import families
from portbench.reference import model as ref

# Samplers with one part left out, for the sampled share's upper reading:
# (temperature, top_p, top_k) as a function of the mix's.
SAMPLER_FAULTS = {
    "top_k_ignored": lambda t, p, k: (t, p, 0),
    "top_p_ignored": lambda t, p, k: (t, 1.0, k),
    "temperature_ignored": lambda t, p, k: (1.0, p, k),
    "unfiltered": lambda t, p, k: (t, 1.0, 0),
}


def sample(records: list, t1: float, count: int, seed: int, greedy: bool = True) -> list:
    """Up to ``count`` greedy (or sampled) requests that finished by
    ``t1``: the one with the most tokens (prompt and answer), then
    others drawn from the seed."""
    done = sorted((r for r in records if r.greedy == greedy and r.ok and r.ended is not None
                   and r.ended <= t1 and r.tokens), key=lambda r: r.index)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + len(r.tokens), r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed % (1 << 64), 7 if greedy else 8])
    picked = rng.permutation(len(rest))[:max(count - 1, 0)]
    return [longest] + [rest[i] for i in sorted(picked)]


def short_answers(records: list, t0: float, t1: float) -> int:
    """Requests that ended in the window short of their length or in error."""
    return sum(1 for r in records
               if r.ended is not None and t0 <= r.ended < t1
               and (not r.ok or len(r.tokens) != r.max_tokens))


@torch.no_grad()
def gaps(cfg: dict, seed: int, greedy: list, sampled: list, prompts: dict, sampling: dict,
         device, dtype: torch.dtype, control: bool = False) -> dict:
    """The numbers compared over the greedy and the sampled requests
    picked (``prompts``: request index → prompt tokens), and with
    ``control`` the control's, the bfloat16 witness's and the planted
    sampler faults'."""
    picked = greedy + sampled
    seqs = [list(prompts[r.index]) + r.tokens[:-1] for r in picked]
    wanted = [list(range(len(prompts[r.index]) - 1, len(prompts[r.index]) - 1 + len(r.tokens)))
              for r in picked]
    family = families.of(cfg)

    def logits(seqs, wanted, precision):
        return family.reference_logits(cfg, seed, seqs, wanted, precision, device, dtype)

    f32 = logits(seqs, wanted, "f32")
    served = [torch.tensor(r.tokens, device=device) for r in picked]
    g_f32, s_f32 = f32[:len(greedy)], f32[len(greedy):]
    stats = spread([ref.gaps(lg, t) for lg, t in zip(g_f32, served)])
    stats.update(outside(s_f32, served[len(greedy):], sampling))
    out = {"tokens_compared": sum(len(r.tokens) for r in picked), "served": stats}
    if control:
        for name, precision in (("control", "fp8"), ("witness_bf16", "bf16")):
            low = logits(seqs[:len(greedy)], wanted[:len(greedy)], precision)
            out[name] = spread([ref.gaps(lg, lo.argmax(-1)) for lg, lo in zip(g_f32, low)])
        t, p, k = sampling["temperature"], sampling["top_p"], sampling["top_k"]
        out["sampler_faults"] = {name: fault_share(s_f32, sampling, *f(t, p, k))
                                 for name, f in SAMPLER_FAULTS.items()}
    return out


def spread(per_request: list) -> dict:
    """The statistics of the greedy requests' per-token gaps that a
    configuration may compare (``widest_gap``, ``request_p25_gap``,
    ``mean_gap``), how the rest lie, and each request's tokens, median
    and lower quartile."""
    if not per_request:
        return {"widest_gap": None, "request_p25_gap": None, "mean_gap": None}
    per_request = [g.float().cpu() for g in per_request]
    g = torch.cat(per_request)
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99]))
    each = [(r.numel(), *torch.quantile(r, torch.tensor([0.5, 0.25])).tolist())
            for r in per_request]
    return {"widest_gap": float(g.max()), "request_p25_gap": max(e[2] for e in each),
            "request_median_gap": max(e[1] for e in each), "mean_gap": float(g.mean()),
            "median_gap": float(q[0]), "p90_gap": float(q[1]), "p99_gap": float(q[2]),
            "share_above_0": float((g > 0).float().mean()),
            "per_request": [[n, round(m, 4), round(p, 4)] for n, m, p in each]}


def outside(logits: list, tokens: list, sampling: dict) -> dict:
    """Over the sampled requests: the share of served tokens below the
    least logit the sampler admits, and the widest such excess (in
    logits). Compared as the sampler compares, on logits / T."""
    if not logits:
        return {"sampled_outside_share": None}
    t, p, k = sampling["temperature"], sampling["top_p"], sampling["top_k"]
    excess = []
    for lg, tok in zip(logits, tokens):
        floor = ref.admitted_floor(lg, t, p, k)
        chosen = lg.float().gather(-1, tok.long()[:, None])[:, 0] / t
        excess.append(((floor - chosen).clamp_min(0) * t).cpu())
    e = torch.cat(excess)
    return {"sampled_outside_share": float((e > 0).float().mean()),
            "sampled_widest_excess": float(e.max()), "sampled_tokens": int(e.numel())}


def fault_share(logits: list, sampling: dict, t: float, p: float, k: int) -> float:
    """The share of tokens, in expectation, that a sampler at (t, p, k)
    serves outside the set that the mix's sampler admits, over the same
    positions."""
    if not logits:
        return float("nan")
    t0, p0, k0 = sampling["temperature"], sampling["top_p"], sampling["top_k"]
    mass, n = 0.0, 0
    for lg in logits:
        admitted = lg.float() / t0 >= ref.admitted_floor(lg, t0, p0, k0)[:, None]
        mass += float(ref.sampler_probs(lg, t, p, k).masked_fill(admitted, 0.0).sum())
        n += lg.shape[0]
    return mass / n
