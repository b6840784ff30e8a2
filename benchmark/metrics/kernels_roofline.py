"""kernels_roofline (device trace): the summed least time of every
launch of the port's CUDA kernels in the traced window (each launch's
operands recorded by the benchmark's wrappers, a graph's at its capture
and counted again at each replay; least times from benchmark/yardstick.py)
over the summed device time of those kernels in the trace (%)."""


def read(run):
    t = run.trace
    if t is None or t["kernel_device_s"] <= 0 or run.least_s <= 0:
        return None
    return 100.0 * run.least_s / t["kernel_device_s"]
