"""The bytes the port's uplink and server kernels must move, counted from
their shapes: each input read once, each output written once (the
kernels' load/store floors: ``scripts/topk_floor.py``, and the bound of
PERF.md's kernel table), by the device function's name as the profiler
records it (``chip_smoke.py::KERNEL_SYMBOLS``)."""

#: bytes a value of a row: ``topk_ef`` reads the delta and the error row
#: and writes the hat and the new error row (4 float32 streams);
#: ``fedams_update`` reads x, m, v, v̂ and the aggregate and writes x, m, v,
#: v̂ (9 float32 streams)
KERNEL_BYTES_PER_VALUE = {"topk_ef_kernel": 4 * 4,
                          "fedams_update_kernel": 9 * 4}

#: bytes a launch besides: ``topk_ef`` reads its row's index (int64)
KERNEL_BYTES_PER_LAUNCH = {"topk_ef_kernel": 8, "fedams_update_kernel": 0}


def bytes_per_round(leaf_sizes: list) -> dict:
    """Each kernel's bytes in a round that launches it once a leaf."""
    d, n = sum(leaf_sizes), len(leaf_sizes)
    return {sym: per * d + KERNEL_BYTES_PER_LAUNCH[sym] * n
            for sym, per in KERNEL_BYTES_PER_VALUE.items()}
