"""Multi-file batch encoding/decoding (lac_tpu/batch.py).

Files are independent, so the simplest correct scale-out is a host
worker pool: each worker thread runs the full frame pipeline. One
thread at a time queues a chunk's device work on a card (the plane
pipeline's dispatch lock: interleaved operator streams cost a thread
switch per operator), queued asynchronously on the card's stream, while other
workers wait for copies, emit and assemble on the host. The kernels are
built once per process (under a lock) and the uploaded tables are
cached, so concurrency costs no extra build. Each worker holds its own
chunks' device buffers: peak device memory grows with ``max_workers``.
With ``mesh=`` each file's chunks spread over the mesh's cards (the
same lock: one stage at a time in the process, whatever its card).

:func:`.pool.encode_pooled` is the same interface with the full blocks
of all items sharing the card's plan batches.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import check_device
from .decoder import FrameDecoder
from .encoder import FrameEncoder


def encode_batch(items, sample_rate, bit_depth, stereo_mode=2, device="cuda", max_workers=4, **encoder_opts):
    """Encode many PCM pairs -> list of .lac frames (input order).

    ``items``: iterable of (left, right) int32 arrays (right empty/None
    for mono). All items share the format parameters. ``device``: "cuda"
    unless the caller asks for "cpu"; a missing card raises.
    ``encoder_opts``: ``FrameEncoder`` setters by name
    (``partitioning_enabled=False`` calls ``set_partitioning_enabled``;
    ``mesh=make_mesh()`` calls ``set_mesh``, so each file's chunks spread
    over the mesh's cards).
    """
    device = check_device(device)
    items = [(l, (r if r is not None else np.empty(0, np.int32))) for l, r in items]

    def one(pair):
        left, right = pair
        enc = FrameEncoder(12, stereo_mode if len(right) else 0, sample_rate, bit_depth, device=device)
        for key, val in encoder_opts.items():
            getattr(enc, f"set_{key}")(val)
        return enc.encode(left, right)

    if len(items) <= 1 or max_workers <= 1:
        return [one(p) for p in items]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as ex:
        return list(ex.map(one, items))


def decode_batch(frames, max_workers=8):
    """Decode many .lac frames -> list of (left, right, header); host-native, no card."""
    if len(frames) <= 1 or max_workers <= 1:
        return [FrameDecoder().decode(f) for f in frames]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(frames))) as ex:
        return list(ex.map(lambda f: FrameDecoder().decode(f), frames))
