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
collective. ``plan_group_sharded`` returns ``meta`` (and, with
``emit_fields``, ``ship``) on the host, and sums ``total_token_bits`` on
the host: the planned-lane count, or with ``emit_fields`` the token bits
that the reference's ``psum`` adds up.
"""

import os

import numpy as np
import torch

from .. import HostCopy, check_device, on_card, upload
from ..plan_graphs import planned

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
    """The product default of pooled waves and the service (the CLI's
    one-shot encode takes it only with ``LAC_TPU_CLI_MESH=1``,
    ``cli._one_shot_mesh``): every visible card whenever there are two or
    more, as the reference's worker pool uses every core without a flag.
    ``LAC_TPU_MESH=0`` turns it off; unset or ``1`` leaves it on. ``None``
    when off, without CUDA or with one card. Counts the cards without
    starting a CUDA context. Bytes never depend on the mesh."""
    if os.environ.get("LAC_TPU_MESH", "1") == "0":
        return None
    if not _DEFAULT_MESH_CACHE:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _DEFAULT_MESH_CACHE.append(tuple(torch.device("cuda", i) for i in range(n)) if n > 1 else None)
    return _DEFAULT_MESH_CACHE[0]


def _shard(a, lo, hi, axis, dev):
    """Rows lo:hi of the numpy array ``a`` along ``axis``, on ``dev``."""
    return upload(np.take(a, np.arange(lo, hi), axis=axis), dev)


def plan_group_sharded(mesh, pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled=True, partitioning_enabled=True,
                       emit_fields=False):
    """:func:`..encoder.plan_group` with the batch axis split into
    ``len(mesh)`` contiguous shards, one per mesh entry, each planned by
    :func:`..plan_graphs.planned` (on a card, a replay of its own graph of
    the shard's shape).

    ``pcm``: (B, n) int32 with B divisible by the mesh size (else
    ValueError); ``lpc_coeffs`` (5, B, 13) int16 and ``lpc_valid`` (5, B)
    bool, numpy arrays as the host's Levinson-Durbin gives them. Each
    shard's inputs are copied from the host to its card and planned there.
    Returns numpy arrays in lane order: ``{"meta": (B, M) int8,
    "total_token_bits": B}`` or, with ``emit_fields``, ``{"meta", "ship":
    (B, 6n) uint8, "total_token_bits"}``, the bits being each token's
    ``q + k + 1`` (Rice-like) or 2 (lac_tpu/parallel/mesh.py:72-87)."""
    B, D = pcm.shape[0], len(mesh)
    if B % D:
        raise ValueError(f"batch of {B} lanes does not split evenly over a mesh of {D}")
    step = B // D
    copies = []
    for s, dev in enumerate(mesh):
        lo, hi = s * step, (s + 1) * step
        with on_card(dev):
            out = planned(_shard(pcm, lo, hi, 0, dev), _shard(lpc_coeffs, lo, hi, 1, dev),
                          _shard(lpc_valid, lo, hi, 1, dev), n, zero_run_enabled, partitioning_enabled,
                          emit_fields=emit_fields)
            copies.append([HostCopy(t) for t in (out if emit_fields else (out,))])
    result = {"meta": np.concatenate([c[0].numpy() for c in copies]), "total_token_bits": B}
    if emit_fields:
        ship = result["ship"] = np.concatenate([c[1].numpy() for c in copies])
        shipv = ship.reshape(B, n, 6)
        payload = shipv[..., :4].copy().view("<u4")[..., 0].astype(np.int64)
        k = shipv[..., 5].astype(np.int64)
        rice_like = (shipv[..., 4] & 7) == 0
        result["total_token_bits"] = int(np.where(rice_like, (payload >> k) + k + 1, 2).sum())
    return result
