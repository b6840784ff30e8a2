"""setup_s (host clock): from the start of the run's process to the start
of the window: importing torch, starting the card, loading the kernels,
making the seed's data and warming up."""


def read(run):
    return run.window[0] - run.t_start
