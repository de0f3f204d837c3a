"""ffn_ms_per_step (ms), layer programs: the decode step's FFN, stamped
by the engine from ``ln2`` to the MLP's residual add (the dense SwiGLU,
or the whole MoE block), in device ms per decode step that ran in the
window (``decode_ffn_ns`` / ``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_ffn_ns")
