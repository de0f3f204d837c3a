"""device_idle_share.decode (%), layer device: 1 − the union of the device
operations' intervals in the profiler's trace over the traced span."""


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.window_s)
