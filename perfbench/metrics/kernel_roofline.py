"""``kernel_roofline``: the port's uplink and server kernels' share of
their memory roofline, in %: the least time the bytes they must move take
at the card's HBM bandwidth (``perfbench/counts/kernels.py``,
``perfbench/counts/peaks.json``), over the device time the profiler
records for them, summed over the profiled rounds. Nothing where the
driver gives no byte counts, where the trace holds none of the kernels,
or without a peak for the card."""
UNIT = "%"


def read(trace):
    if not trace.kernel_bytes or trace.peaks is None:
        return None
    seconds = sum(e - s for name, s, e in trace.device
                  if any(sym in name for sym in trace.kernel_bytes)) / 1e9
    if seconds <= 0:
        return None
    bound = (sum(trace.kernel_bytes.values()) * len(trace.rounds)
             / trace.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
