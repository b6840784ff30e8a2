"""Cross-file chunk pooling for many-file encoding (lac_tpu/pool.py).

The reference's thread pool saturates every core with one-block tasks
regardless of which file a block came from (lac/encoder.cpp:259-443: the
task queue holds (block index, both channels) items, provenance never
matters). The counterpart on the card is to fill K-wide chunks with
16384-sample blocks drawn from ALL queued files: one
:class:`~lac_tpu_torch.device_pipeline.PlanePipeline` runs over the
concatenation of every file's full-block plane rows, so a batch of
short files plans in the same full-width batches as one long file,
instead of one narrow plan per file, or none on the card at all for a
file under ``device_pipeline.MIN_FULL_BLOCKS`` full blocks.

Byte parity is structural: every block's plan and emission read only
that block's own plane rows (``plan_group`` is per lane, stereo
decisions are per block, chunk boundaries only change batch shapes), so
the per-file payloads taken out of a wave are those of encoding each
file alone (tests/test_torch_pool.py; chip_smoke.py at real size).

Two consumers:

- :func:`encode_pooled`: the library batch call (``batch.encode_batch``
  with pooling);
- :func:`prepare_encode_job` + :func:`run_group_wave`: the split phases
  for a serving loop: prescreen and read jobs, pool compatible ones
  into waves, and release each file's plane results (through the
  pipeline's progress callback) while later chunks are on the device.

Against ``lac_tpu.pool``: there is one backend, so the ``xp=numpy``
fallback of ``encode_pooled`` and the ``is_jax`` gate are gone; pooling
needs the native runtime (its plane replay writes a wave's bytes), so
under ``LAC_TPU_NO_NATIVE=1`` every job and item is encoded on its own,
as in lac_tpu; planes reach an encoder through
``FrameEncoder.encode_frame(left, right, planes)``, not through a
private attribute; and a wave marks the process warm in
``PlanePipeline.run``.

A wave runs on its template encoder's mesh (:mod:`.parallel.mesh`): a
template that :func:`run_group_wave` builds itself on the card takes
:func:`.parallel.default_mesh`, every visible card when there are two
or more, as the CLI does. :func:`encode_pooled` never puts items with
different meshes in one wave.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from . import check_device, host_empty, torch_dtype
from .format import constants as C
from .utils import debug as _dbg

__all__ = ["PreparedEncode", "prepare_encode_job", "run_group_wave", "split_waves", "encode_pooled"]

# one wave's combined plane rows stay on the host for its lifetime (in
# pinned memory on a card); the cap bounds that for a long queue (4096
# blocks = 256 MB of int16 stereo planes). Parity is unaffected:
# chunking never changes a lane's bytes.
_MAX_WAVE_BLOCKS = 4096

_MODE_KIND = {C.STEREO_LR: "lr", C.STEREO_MS: "ms", C.STEREO_PER_BLOCK: "auto"}


@dataclass(eq=False)
class PreparedEncode:
    """An encode job that can join a pooled device wave."""

    parts: list  # full job vector ["encode", in, out, flags...]
    in_path: str
    wav: tuple  # (left, right, channels, sample_rate, bit_depth)
    kind: str  # mono | lr | ms | auto
    nfull: int  # full 16384-sample blocks
    dt: object  # plane dtype (np.int16 for 16-bit content)
    key: tuple = field(default=())  # wave-compatibility group key
    opts: dict = field(default_factory=dict)
    effective_mode: int = 0


def prepare_encode_job(parts):
    """Prescreen one job vector (the CLI's argv) for pooling.

    Returns a :class:`PreparedEncode` (WAV already read) when the job
    can join a pooled wave, else ``None``: the caller then runs it
    through the ordinary CLI path, which reproduces every error
    message, debug print and routing decision exactly. Does no device
    work.
    """
    from . import cli
    from .io import read_wav
    from .runtime.native import native_available
    from .stream import scan_wav
    from .utils.staged_output import paths_refer_to_same_file

    if len(parts) < 3 or parts[0] != "encode":
        return None
    in_path, out_path = parts[1], parts[2]
    opts = cli._parse_encode_flags(parts[3:])
    if opts is None:
        return None
    if (
        opts["debug_zr"]
        or opts["debug_lpc"]
        or opts["debug_stereo_est"]
        or opts["debug_partitions"]
        or opts["debug_threads"]
    ):
        # debug paths print per-block / per-encode data that a shared
        # wave would perturb (--debug-threads counts this job's own
        # emission workers; the wave emits with group[0]'s settings):
        # keep them one-shot
        return None
    if paths_refer_to_same_file(in_path, out_path):
        return None
    if not native_available():
        return None  # pooled waves replay their plans natively
    # scan before read (cli.py orders the same way): a file headed for
    # the bounded-memory streaming route must not be read whole here
    # first: that is the very spike the route exists to prevent
    info = scan_wav(in_path)
    if info is None:
        return None
    stream_threshold = cli._stream_threshold()
    if stream_threshold > 0 and -(-info.frames // C.MAX_BLOCK_SIZE) >= stream_threshold:
        return None  # bounded-memory streaming route
    wav = read_wav(in_path)
    if wav is None:
        return None
    left, _right, channels, _sample_rate, bit_depth = wav
    nfull = len(left) // C.MAX_BLOCK_SIZE
    if nfull < 1:
        return None
    effective_mode = 0 if channels == 1 else opts["stereo_mode"]
    kind = "mono" if channels == 1 else _MODE_KIND[effective_mode]
    dt = np.int16 if bit_depth == 16 else np.int32
    # jobs sharing a key can share one wave: same plane layout (kind,
    # dtype) and same plan semantics (partitioning; zero-run is always
    # on via the CLI). Sample rate and thread flags only affect headers
    # and host worker counts, never block bytes.
    key = (kind, np.dtype(dt).str, bool(opts["partitioning"]))
    return PreparedEncode(parts=list(parts), in_path=in_path, wav=wav, kind=kind, nfull=nfull, dt=dt,
                          key=key, opts=opts, effective_mode=effective_mode)


def _build_views(group, alloc):
    """Concatenate the group's full-block plane rows into one (total, N)
    host tensor per channel from ``alloc(shape, dtype)`` (pinned memory
    for a wave on a card, :func:`.host_empty`), filled through numpy
    views of it; returns (lmat, rmat, spans)."""
    N = C.MAX_BLOCK_SIZE
    total = sum(j.nfull for j in group)
    dt = torch_dtype(group[0].dt)
    lmat = alloc((total, N), dt)
    rmat = alloc((total, N), dt) if group[0].kind != "mono" else None
    lview, rview = lmat.numpy(), rmat.numpy() if rmat is not None else None
    spans = []
    off = 0
    for j in group:
        left, right = j.wav[0], j.wav[1]
        # int32 -> int16 assignment is exact: WAV reads sign-extend into
        # the declared bit depth and encode_pooled validates every item
        # first, so 16-bit content is in int16 range
        lview[off : off + j.nfull] = left[: j.nfull * N].reshape(j.nfull, N)
        if rview is not None:
            rview[off : off + j.nfull] = right[: j.nfull * N].reshape(j.nfull, N)
        spans.append((off, j.nfull))
        off += j.nfull
    return lmat, rmat, spans


def run_group_wave(group, file_done, template_enc=None, device="cuda"):
    """Run ONE pooled device wave over every full block of ``group``
    (PreparedEncode items sharing ``.key``).

    The wave takes its knobs (zero-run, partitioning, threads), its
    device and its mesh from ``template_enc``; when omitted, one is built
    on ``device`` from the first job's options, on the default mesh when
    ``device`` is a card (:func:`.parallel.default_mesh`).
    ``file_done(i, (payloads, flags, uncertain))`` fires in group order
    as soon as file ``i``'s blocks have emitted: the pipeline finishes
    chunks in block order, so early files' host work (tail block, frame
    assembly, output write) can overlap later chunks' device compute.
    The triple is what ``FrameEncoder.encode_frame`` takes as ``planes``.
    """
    with _dbg.phase("pool_wave", files=len(group)):
        _run_group_wave(group, file_done, template_enc, device)


def _run_group_wave(group, file_done, template_enc, device):
    from . import device_pipeline as DP

    if template_enc is None:
        from .cli import _resolve_threads
        from .encoder import FrameEncoder

        g0 = group[0]
        template_enc = FrameEncoder(12, g0.effective_mode, g0.wav[3], g0.wav[4], device=device)
        template_enc.set_partitioning_enabled(bool(g0.opts["partitioning"]))
        template_enc.set_thread_count(_resolve_threads(g0.opts["thread_count"]))
        if check_device(device).type == "cuda":
            from .parallel import default_mesh

            template_enc.set_mesh(default_mesh())
    mesh = template_enc.mesh
    with _dbg.phase("wave_views"):
        lmat, rmat, spans = _build_views(group, host_empty(mesh or (template_enc.device,)))
    total = lmat.shape[0]

    nxt = 0

    def release(done, payloads, flags, uncertain):
        nonlocal nxt
        while nxt < len(spans):
            off, nf = spans[nxt]
            if off + nf > done:
                break
            blocks = range(off, off + nf)
            pp = {b - off: payloads.pop(b) for b in blocks}
            fl = {b - off: flags.pop(b) for b in blocks if b in flags}
            un = {b - off: uncertain.pop(b) for b in blocks if b in uncertain}
            file_done(nxt, (pp, fl, un))
            nxt += 1

    pipe = DP.PlanePipeline(template_enc, None, None, total, group[0].kind,
                            template_enc.device if mesh is None else None, views=(lmat, rmat), mesh=mesh)
    pipe.run(progress_cb=release)
    if nxt != len(spans):
        raise RuntimeError("wave ended with unreleased files")


def split_waves(records, nfull_of=lambda r: r.nfull, max_blocks=None):
    """Split a compatible group into bounded-memory waves (greedy; a
    single file larger than the cap still forms its own wave)."""
    if max_blocks is None:
        max_blocks = _MAX_WAVE_BLOCKS  # read at call time, so a caller may lower the module's cap
    waves, cur, blocks = [], [], 0
    for r in records:
        if cur and blocks + nfull_of(r) > max_blocks:
            waves.append(cur)
            cur, blocks = [], 0
        cur.append(r)
        blocks += nfull_of(r)
    if cur:
        waves.append(cur)
    return waves


def encode_pooled(items, sample_rate, bit_depth, stereo_mode=2, device="cuda", max_workers=4, **encoder_opts):
    """``batch.encode_batch`` with cross-file chunk pooling: the full
    16384-sample blocks of every item share device waves (at most
    ``_MAX_WAVE_BLOCKS`` blocks each), so many short inputs plan in
    full-width batches. Every item with at least
    one full block is planned on ``device`` ("cuda" unless the caller
    asks for "cpu"; a missing card raises); tails and items without a
    full block take the host route, on up to ``max_workers`` threads.
    ``encoder_opts`` are ``FrameEncoder`` setters by name: ``mesh=``
    (:func:`.parallel.make_mesh`) spreads the waves over its cards.
    Returns frames in order; bytes identical to per-item
    :meth:`FrameEncoder.encode`.

    Spans (:mod:`.utils.debug`): the call's own (``encode_pooled``, the
    request), ``pool_prepare`` up to the first wave, each wave's
    ``pool_wave``, and each item's ``pool_finish`` on its worker thread.
    ``LAC_TPU_PROFILE`` writes a Chrome trace of the call.
    """
    with _dbg.device_trace(), _dbg.request("encode_pooled"):
        return _encode_pooled(items, sample_rate, bit_depth, stereo_mode, device, max_workers, encoder_opts)


def _encode_pooled(items, sample_rate, bit_depth, stereo_mode, device, max_workers, encoder_opts):
    from .encoder import FrameEncoder
    from .runtime.native import native_available

    with _dbg.phase("pool_prepare"):
        device = check_device(device)
        items = [
            (np.ascontiguousarray(l, np.int32),
             np.ascontiguousarray(r if r is not None else np.empty(0, np.int32), np.int32))
            for l, r in items
        ]

        encs = []
        for left, right in items:
            enc = FrameEncoder(12, stereo_mode if len(right) else 0, sample_rate, bit_depth, device=device)
            for key, val in encoder_opts.items():
                getattr(enc, f"set_{key}")(val)
            # validate BEFORE any pooled device work: per-item encode()
            # rejects out-of-range PCM (reference lac/encoder.cpp:220-241),
            # and the int16 plane matrices would truncate it: such an item
            # must raise here and never reach a wave
            if len(left):
                enc._validate(left, right)
            encs.append(enc)

        poolable = native_available()
        groups = {}
        for i, (left, right) in enumerate(items):
            nfull = len(left) // C.MAX_BLOCK_SIZE
            if nfull < 1 or not poolable:
                continue
            kind = "mono" if not len(right) else _MODE_KIND[stereo_mode]
            prep = PreparedEncode(parts=[], in_path="", wav=(left, right, 0, sample_rate, bit_depth), kind=kind,
                                  nfull=nfull, dt=np.int16 if bit_depth == 16 else np.int32, key=(kind,))
            # items pool with items of the same mesh only: the wave runs on its
            # template's (a tuple of devices compares by value)
            groups.setdefault((kind, encs[i].mesh), []).append((i, prep))

    planes = {}  # item -> its full blocks' (payloads, flags, uncertain)
    for pairs in groups.values():
        for wave in split_waves(pairs, nfull_of=lambda ip: ip[1].nfull):
            idxs = [i for i, _ in wave]

            def stash(j, result, idxs=idxs):
                planes[idxs[j]] = result

            run_group_wave([p for _, p in wave], stash, template_enc=encs[idxs[0]])

    batch = _dbg.current()

    def one(i):
        with _dbg.adopt(batch), _dbg.phase("pool_finish", cpu=True, item=i):
            if not poolable:  # no waves: each item on its own, as FrameEncoder.encode does
                return encs[i].encode(*items[i])
            return encs[i].encode_frame(*items[i], planes.get(i))

    if len(items) <= 1 or max_workers <= 1:
        return [one(i) for i in range(len(items))]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as ex:
        return list(ex.map(one, range(len(items))))
