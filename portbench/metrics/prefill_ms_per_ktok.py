"""prefill_ms_per_ktok (ms per 1,000 tokens), layer programs: the device
time of the prefill and extend programs dispatched in the window (a
CUDA event pair around each call), over the real prompt tokens
prefilled in the window (``prefill_tokens``), times 1,000."""


def read(run):
    if run.spans is None or not run.spans.cuda:
        return None
    calls = run.spans.within("prefill", run.t0, run.t1)
    tokens = run.delta("prefill_tokens")
    if not calls or tokens <= 0:
        return None
    return sum(s.device_ms() for s in calls) / tokens * 1e3
