"""tpot_p95_ms (ms): the 95th percentile, over every request that ended
in the window with two tokens or more, of (last token − first token) /
(tokens − 1). Host clock."""

from portbench.yardstick import quantile


def read(run):
    per = [(r.token_times[-1] - r.token_times[0]) / (len(r.token_times) - 1) * 1e3
           for r in run.records
           if r.ended is not None and run.t0 <= r.ended < run.t1 and len(r.token_times) > 1]
    return quantile(per, 0.95) if per else None
