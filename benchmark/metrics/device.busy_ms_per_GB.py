"""device.busy_ms_per_GB (device trace): the union of device activity in
the traced window (averaged over the cards in use) over the GB of PCM the
window encoded."""


def read(run):
    if run.trace is None or not run.pcm_bytes:
        return None
    return 1e3 * run.trace["busy_s"] / (run.pcm_bytes / 1e9)
