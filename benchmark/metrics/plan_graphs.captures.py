"""plan_graphs.captures (program counter): graphs the port captured inside
the window, summed over ``plan_graphs.CACHES``' kinds (captures at the
window's end less those at its start). A capture there means that set-up
missed a shape the window replays."""


def read(run):
    return run.counters.get("plan_graphs.captures")
