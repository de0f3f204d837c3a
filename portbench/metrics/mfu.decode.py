"""mfu.decode (%), layer device: the whole step's share of the card's bf16
peak. The model FLOPs of the window, each prompt prefilled in it (its
first token came then) and each decode token made in it, counted from
the real lengths (``yardstick.prefill_flops`` / ``decode_flops``;
padding and idle slots count nothing), over the window at 989 TFLOP/s."""

from portbench import yardstick


def read(run):
    if not run.cuda:
        return None
    flops = sum(yardstick.prefill_flops(run.config, r.prompt_len) if j == 0
                else yardstick.decode_flops(run.config, r.prompt_len + j - 1)
                for r, j in run.tokens_between(run.t0, run.t1))
    if flops <= 0:
        return None
    return 100.0 * flops / ((run.t1 - run.t0) * yardstick.PEAK_BF16_FLOPS)
