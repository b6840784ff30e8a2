"""device.idle_pct.batch (device trace): 100 less the union of device
activity over the traced window; on several cards the mean over them."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
