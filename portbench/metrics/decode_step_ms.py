"""decode_step_ms (ms), layer programs: the device time of the decode
chunks enqueued in the window (a CUDA event pair around each
``_run_decode_step``), over the decode steps that ran (``decode_steps``
− ``early_exit_steps`` over the window)."""


def read(run):
    if run.spans is None or not run.spans.cuda:
        return None
    chunks = run.spans.within("_run_decode_step", run.t0, run.t1)
    steps = run.delta("decode_steps") - run.delta("early_exit_steps")
    if not chunks or steps <= 0:
        return None
    return sum(s.device_ms() for s in chunks) / steps
