"""attn_ms_per_step (ms), layer programs: the decode step's attention,
stamped by the engine from ``ln1`` to the residual add after ``wo``
(q/k/v, rope, the KV write, K1), in device ms per decode step that ran
in the window (``decode_attn_ns`` / ``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_attn_ns")
