"""placement_stall_ms_per_step (ms), layer engine: the part of the gaps
between decode chunks (``decode_gap_ms_per_step``) spent in gaps that
hold a prefill, extend or insert program, per decode step that ran in
the window (``decode_gap_placement_ns`` / ``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_gap_placement_ns")
