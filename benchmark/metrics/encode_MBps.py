"""encode_MBps (host clock): PCM bytes of every input whose encode
completed in the window, at the input's own width (a CD frame is 4 B, a
24-bit stereo frame 6 B), over the window's time; 1 MB is 10^6 B."""


def read(run):
    if not run.pcm_bytes:
        return None
    return run.pcm_bytes / 1e6 / run.window_s
