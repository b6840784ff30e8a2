"""lac_tpu_torch — the LAC codec on PyTorch + CUDA.

A port of :mod:`lac_tpu` (JAX/XLA/Pallas) for NVIDIA Hopper. The array
programs (residuals, cost models, Rice k-adaptation, plan selection)
are PyTorch; the six Pallas kernels of the planner's path are CUDA C++
kernels written for ``sm_90a`` (``lac_tpu_torch/csrc``), each with a
plain PyTorch version that CPU tensors take (:mod:`.ops.cuda_kernels`).

The port owns its host layers: wire format (``format/``), bit reader
(``bitio/``), WAV I/O (``io/``), staged output and thread resolution
(``utils/``), the native C++ runtime (``runtime/``: plan replay, host
planner, decoders), the 80-bit Levinson-Durbin, the host route and frame
assembly (``encoder``), the decoder and the CLI. It imports torch, numpy
and the standard library, never ``jax`` and nothing of ``lac_tpu``.
Output bytes are identical to :mod:`lac_tpu`'s for the same input and
knobs.

Entry points (``encoder.FrameEncoder``, ``cli.main``,
``stream.encode_wav_to_lac``, ``batch.encode_batch``,
``pool.encode_pooled``) run on the CUDA card unless the caller passes
``device="cpu"``; array helpers run on the device of the tensors they
are given. With two or more cards visible, pooled waves and the service
spread their chunks over every card (:func:`.parallel.default_mesh`;
``LAC_TPU_MESH=0`` turns it off); the CLI's one-shot encode runs on one
card unless ``LAC_TPU_CLI_MESH=1`` asks for the mesh.
"""

import contextlib

import numpy as np
import torch

from .utils import debug as _dbg

__version__ = "0.1.0"


def on_card(device):
    """Context that makes ``device`` the current CUDA device of this
    thread (nothing for the CPU): what a bare "cuda", a new CUDA event
    or a pinned buffer takes as its card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def torch_dtype(dtype):
    """The torch dtype of numpy dtype ``dtype``."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def pinned_empty(shape, dtype):
    """An uninitialised host tensor in page-locked memory from torch's
    caching host allocator. Allocating runs no CPU operator, and the
    allocator hands a freed block out again only once the copies recorded
    on it have completed."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def pageable_empty(shape, dtype):
    """An uninitialised host tensor in ordinary (pageable) memory."""
    return torch.empty(shape, dtype=dtype)


def host_empty(devices):
    """The ``alloc(shape, dtype)`` of host tensors bound for ``devices``:
    :func:`pinned_empty` where one of them is a card, else
    :func:`pageable_empty`."""
    return pinned_empty if any(torch.device(d).type == "cuda" for d in devices) else pageable_empty


def stage(a, dtype=None, alloc=None):
    """numpy array (or host tensor) -> a host tensor of its shape from
    ``alloc(shape, dtype)`` (:func:`pinned_empty` by default), filled by
    one ``np.copyto`` on the calling thread (cast to ``dtype`` where
    given). No torch CPU operator touches the bytes, so torch's intra-op
    thread pool is not woken, and a strided ``a`` costs no second copy."""
    a = np.asarray(a)
    t = (alloc or pinned_empty)(a.shape, torch_dtype(dtype or a.dtype))
    np.copyto(t.numpy(), a, casting="unsafe")
    return t


def upload(a, device):
    """numpy array or host tensor -> tensor on ``device`` (a card with an
    index lands on that card, whatever this thread's current device).

    On the CPU the result shares ``a``'s memory where it can. On a card
    the copy is asynchronous, so an upload never waits for the device
    work queued before it: a pinned tensor is sent as it is, anything
    else is first staged into fresh pinned memory by numpy
    (:func:`stage`). There it records a span ``upload`` with ``bytes``,
    the bytes sent, and ``staged``, the bytes copied on the host to stage
    them."""
    if device.type != "cuda":
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    direct = isinstance(a, torch.Tensor) and a.is_pinned()
    with _dbg.phase("upload", bytes=a.nbytes, staged=0 if direct else a.nbytes):
        return (a if direct else stage(a)).to(device, non_blocking=True)


class HostCopy:
    """A device->host copy started now and awaited by :meth:`numpy`
    (pinned buffer + CUDA event, both made on the tensor's card; the
    tensor itself on the CPU)."""

    def __init__(self, t):
        self.event = None
        if t.device.type == "cuda":
            with on_card(t.device):
                self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def check_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked: a CUDA
    device without a usable card raises instead of silently running on
    the CPU. Starts no CUDA context (``torch.cuda.is_available`` counts
    the cards and no more), so an entry point can insist on the card
    before it knows whether the input will reach it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def resolve_device(device) -> torch.device:
    """:func:`check_device`, then the card's index filled in: a bare
    "cuda" becomes this thread's current device (in a mesh's dispatch
    thread, that thread's card), which starts the CUDA context."""
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
