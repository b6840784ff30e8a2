"""encoded_size_pct (taken by the benchmark on the host): the bytes of the
streams of every input whose encode completed in the window over those
inputs' PCM bytes (%). The window's work is fixed by the seed's batches,
so a coarser plan search shows here as larger streams."""


def read(run):
    if not run.pcm_bytes or not run.stream_bytes:
        return None
    return 100.0 * run.stream_bytes / run.pcm_bytes
