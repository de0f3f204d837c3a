"""setup_s (s): from the start of the process to the opening of the
measured window: weights drawn, engine built, warmup (the kernel build
and the decode ring's capture) and the load's lead-in. Host clock."""


def read(run):
    return run.setup_s
