"""moe_route_ms_per_step (ms), layer moe: the MoE blocks less their
expert products (router, top-k, the assignment sort, the gather, the
combine: the engine's stamps around ``ops/moe.py::_experts`` inside
each MoE layer's FFN), in device ms per decode step that ran in the
window (``decode_moe_route_ns`` / ``decode_timed_steps``)."""

from portbench.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "decode_moe_route_ns")
