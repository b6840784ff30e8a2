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

__version__ = "0.1.0"


def on_card(device):
    """Context that makes ``device`` the current CUDA device of this
    thread (nothing for the CPU): what a bare "cuda", a new CUDA event
    or a pinned buffer takes as its card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def upload(a, device):
    """numpy array -> tensor on ``device`` (a card with an index lands on
    that card, whatever this thread's current device). CUDA copies go
    through pinned memory without blocking, so an upload never waits for
    the device work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


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
