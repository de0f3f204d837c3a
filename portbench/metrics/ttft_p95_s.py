"""ttft_p95_s (s): the 95th percentile, over every request due in the
window, of the time from when it was due to its first token. A request
with no first token when the load settled counts with the time it had
waited by then. Host clock."""

from portbench.yardstick import quantile


def read(run):
    window = run.due_in_window()
    if not window:
        return None
    end = max([t for r in run.records for t in r.token_times[:1]] + [run.t1])
    return quantile([(r.first if r.first is not None else end) - r.due for r in window], 0.95)
