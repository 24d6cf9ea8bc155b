"""``mfu``: the whole round's share of the card's peak, in %: the model
FLOPs of a round's local training (``perfbench/counts/``; no recompute
counted) over the round's time and the peak of the configuration's
compute precision (``perfbench/counts/peaks.json``). The round's time is
the traced run's measured window over its rounds, on the host's clock:
the profiled rounds, which the profiler itself slows, are not used.
Nothing without a peak for the card."""
UNIT = "%"


def read(trace):
    if trace.peaks is None or not trace.flops_per_round:
        return None
    peak = trace.peaks["flops_per_s"][trace.precision]
    return 100.0 * trace.flops_per_round / trace.round_s / peak
