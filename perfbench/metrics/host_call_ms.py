"""``host_call_ms``: the mean host time of a round's call, from its entry
to its return, before the host reads its metrics: the round driver's
staging of the round's inputs, their copy to the card and the program's
launch. Timed on the host's clock over the traced run's measured window,
whose rounds the profiler does not cover."""
UNIT = "ms"


def read(trace):
    if not trace.call_s:
        return None
    return sum(trace.call_s) * 1e3 / len(trace.call_s)
