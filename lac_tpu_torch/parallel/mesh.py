"""Several cards: spread the block axis over a mesh of devices
(lac_tpu/parallel/mesh.py).

Blocks are independent (v3 byte-bounded payloads), so the mapping is
pure data parallelism with no traffic between cards: each card plans its
own blocks, and only the compact plan ``meta`` comes back to the host.

A mesh is a tuple of ``torch.device``, each with its index, in shard
order. Entries may repeat: ``make_mesh(["cuda:0", "cuda:0"])`` is a
two-shard stand-in on one card, and ``make_mesh(["cpu"] * 4)`` one on
the CPU (the tests). A tuple compares by value, so two encoders on the
same cards hold equal meshes.

The plane pipeline (:mod:`..device_pipeline`) takes a mesh whole: chunk
``j`` of a file or wave goes to entry ``j % len(mesh)``, at the chunk
width one card would use, so every plan shape and the operators and
kernel launches per encode are one card's. :func:`plan_group_sharded`
is the reference's batch-sharded plan, for callers that hold one plan
batch.

Against ``lac_tpu.parallel.mesh``: there is no ``shard_map`` and no
collective. ``plan_group_sharded`` returns ``meta`` on the host and the
planned-lane count as ``total_token_bits`` (the reference's
``emit_fields=False`` value); ``emit_fields=True`` and its ``ship``
token fields are not ported.
"""

import os

import numpy as np
import torch

from .. import HostCopy, check_device, on_card, upload

_DEFAULT_MESH_CACHE = []


def make_mesh(devices=None):
    """A mesh over ``devices`` (default: every visible CUDA card). Each
    entry becomes a ``torch.device``; a bare ``"cuda"`` gets the current
    card's index, and a card index past the visible ones raises."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = check_device(d)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            elif dev.index >= torch.cuda.device_count():
                raise ValueError(f"mesh device {dev} is not visible ({torch.cuda.device_count()} cards)")
        mesh.append(dev)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return tuple(mesh)


def default_mesh():
    """The product default (CLI, pooled waves, the service): every visible
    card whenever there are two or more, as the reference's worker pool
    uses every core without a flag. ``LAC_TPU_MESH=0`` turns it off; unset
    or ``1`` leaves it on. ``None`` when off, without CUDA or with one
    card. Counts the cards without starting a CUDA context. Bytes never
    depend on the mesh: the switch is for debugging."""
    if os.environ.get("LAC_TPU_MESH", "1") == "0":
        return None
    if not _DEFAULT_MESH_CACHE:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _DEFAULT_MESH_CACHE.append(tuple(torch.device("cuda", i) for i in range(n)) if n > 1 else None)
    return _DEFAULT_MESH_CACHE[0]


def _shard(a, lo, hi, axis, dev):
    """Rows lo:hi of the numpy array ``a`` along ``axis``, on ``dev``."""
    return upload(np.take(a, np.arange(lo, hi), axis=axis), dev)


def plan_group_sharded(mesh, pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled=True, partitioning_enabled=True):
    """:func:`..encoder.plan_group` with the batch axis split into
    ``len(mesh)`` contiguous shards, one per mesh entry.

    ``pcm``: (B, n) int32 with B divisible by the mesh size (else
    ValueError); ``lpc_coeffs`` (5, B, 13) int16 and ``lpc_valid`` (5, B)
    bool, numpy arrays as the host's Levinson-Durbin gives them. Each
    shard's inputs are copied from the host to its card and planned there. Returns ``{"meta": (B, M) int8 numpy in lane order,
    "total_token_bits": B}``."""
    from ..encoder import plan_group

    B, D = pcm.shape[0], len(mesh)
    if B % D:
        raise ValueError(f"batch of {B} lanes does not split evenly over a mesh of {D}")
    step = B // D
    copies = []
    for s, dev in enumerate(mesh):
        lo, hi = s * step, (s + 1) * step
        with on_card(dev):
            meta = plan_group(_shard(pcm, lo, hi, 0, dev), _shard(lpc_coeffs, lo, hi, 1, dev),
                              _shard(lpc_valid, lo, hi, 1, dev), n, zero_run_enabled, partitioning_enabled)
            copies.append(HostCopy(meta))
    return {"meta": np.concatenate([c.numpy() for c in copies]), "total_token_bits": B}

