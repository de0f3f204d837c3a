"""decode_gap_ms_per_step (ms), layer engine: device time from one decode
chunk's end event to the next chunk's start event (the engine's event
pairs; placements, reads and host scheduling between chunks), per
decode step that ran in the window (``decode_gap_ns`` /
``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_gap_ns")
