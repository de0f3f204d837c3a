"""Per-step readings of the engine's own device timeline
(``omnia_tpu_torch/utils/timeline.py``, on with the flight recorder, so
in the traced run): its counters' growth over the window, from
``engine.metrics`` at "open" and "close"."""


def ms_per_step(run, counter: str):
    """``counter``'s ns over the window per decode step that ran
    (``decode_timed_steps``), in ms; None where the engine keeps no such
    counters or no timed step ran in the window."""
    if "decode_timed_steps" not in run.counters["close"]:
        return None
    steps = run.delta("decode_timed_steps")
    return run.delta(counter) / steps / 1e6 if steps > 0 else None
