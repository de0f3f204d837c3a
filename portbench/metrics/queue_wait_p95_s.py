"""queue_wait_p95_s (s), layer engine: the 95th percentile, over the
requests due in the window, of the flight recorder's ``queue_s``
(submit to claim). Read in the traced run, where the recorder is on."""

from portbench.yardstick import quantile


def read(run):
    waits = [run.breakdowns[r.request_id]["queue_s"] for r in run.due_in_window()
             if r.request_id in run.breakdowns]
    return quantile(waits, 0.95) if waits else None
