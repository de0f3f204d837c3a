"""output_tokens_per_s (tokens/s): every output token pushed to a client
in the window, over the window. Host clock."""


def read(run):
    n = sum(1 for _ in run.tokens_between(run.t0, run.t1))
    return n / (run.t1 - run.t0) if n else None
