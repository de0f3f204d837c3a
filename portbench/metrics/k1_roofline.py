"""k1_roofline (%), layer kernels: the least time the decode-attention
kernel K1 (``decode_kernel``) could take for the calls of the traced
span, over its device time in the profiler's trace. The bytes are
counted from the traffic, not from what the kernel reads: for each
token a decode step made in the span, at position p, its q row, its K
and V rows 0..p and its output row, in every layer, against 3.35 TB/s.
Tokens are placed in the span by when they reached the client, which
runs behind the device by the chunks in flight at either edge."""

from portbench import yardstick


def read(run):
    if run.profile is None:
        return None
    seconds = run.profile.op_seconds("decode_kernel")
    if seconds <= 0:
        return None
    a, b = run.trace_span
    need = sum(yardstick.k1_bytes(run.config, r.prompt_len + j - 1)
               for r, j in run.tokens_between(a, b) if j >= 1)
    if need <= 0:
        return None
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / seconds
