"""``device_idle_pct``: the share of the traced window, in %, in which no
operation (kernel, copy or set) runs on the card, from the profiler's
device intervals. Nothing without a device trace."""
UNIT = "%"


def read(trace):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
