"""sampler_ms_per_step (ms), layer programs: the decode step's head,
stamped by the engine from the final norm to the sampled tokens (the
head product, the logits' gather, the sampler and any grammar mask), in
device ms per decode step that ran in the window (``decode_head_ns`` /
``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_head_ns")
