"""decode_occupancy (%), layer engine: tokens made by decode steps over
(decode steps that ran × slots), in the window, from the engine's
counters. A placement's first token comes from its prefill and is not a
decode token; steps a ring chunk skipped once its slots were done did
not run."""


def read(run):
    decode_tokens = run.delta("tokens_generated") - run.delta("prefill_steps")
    steps = run.delta("decode_steps") - run.delta("early_exit_steps")
    if steps <= 0 or decode_tokens <= 0:
        return None
    return 100.0 * decode_tokens / (steps * run.num_slots)
