"""The program's own CUDA kernels' share of their roofline over the
traced stretch: the least time of every launch (its shapes priced by
``counts.KERNELS``; launches counted by the program's counters) over
the device time of those kernels, found by name in the trace."""

from benchmark import counts


def read(run):
    t = run.trace
    if t is None or t.port_kernel_s <= 0 or not t.launch_delta:
        return None
    least = 0.0
    for name, launches in t.launch_delta.items():
        calls = [c for c in t.kernel_calls if c["kernel"] == name]
        if not calls:
            return None  # a launch whose shapes were not seen cannot be priced
        per_call = sum(counts.KERNELS[name](c).least_s() for c in calls) / len(calls)
        least += launches * per_call
    return 100.0 * least / t.port_kernel_s
