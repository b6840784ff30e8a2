"""The plain reference that decides ``correct``: a reader of the ``.lac`` v3
stream and a model of the reference encoder's choices, in Python and
NumPy, which import nothing of the program.

The configurations state the codec's guarantees: every stream decodes to
its input, sample for sample, at the input's rate, width and channels;
and every block is coded as the reference encoder codes it, with the
plan its cost models choose. :func:`judge` holds the program's streams
to both. Every stream of the window is parsed whole down to its block
table (header, block count, block and payload sizes against the input's
frames); the blocks of a sample drawn from the seed (:func:`draw_sample`)
are decoded whole (the per-block stereo flag, each channel's predictor,
coefficients, residual control, partitions, Rice, zero-run, bin and
static payloads and padding, the closed-loop restore and the mid/side
inverse) and compared with the input's samples; and each sampled
channel's plan is worked out again from its samples (:func:`plan_fault`):
the predictor against every fixed and FIR candidate, then the residual
mode, the Rice k and the partition order and every part's mode and k of
the chosen predictor's residuals, by the reference encoder's cost models
and tie-breaks. A plan that codes the same samples in more bits than the
encoder's choice is wrong, not faster.

The wire rules are those of the reference format (reference docs
format.md; its decoder block/decoder.cpp and lac/decoder.cpp), written out
again here from the port's Python reader (lac_tpu_torch/decoder.py:42-270,
bitio/reader.py, format/*.py, ops/predictors.py:109-160, ops/stereo.py:29)
as a frozen copy: a later change to the program does not change it. The
cost models and the choice rules are those of the reference encoder
(block/encoder.cpp:41-456 and rice.hpp:45-114, as lac_tpu/encoder.py:
180-460 states them), written out again over one channel block in NumPy.
"""

import numpy as np

MAX_BLOCK_SIZE = 16384
HEADER_BYTES = 10
SYNC_WORD = 0x4C41
STEREO_LR, STEREO_MS, STEREO_PER_BLOCK = 0, 1, 2
MODE_RICE, MODE_ZERO_RUN, MODE_BIN, MODE_STATIC = 0, 1, 2, 3
PREDICTOR_FIXED, PREDICTOR_FIR, PREDICTOR_LPC = 0, 1, 2
ZR_TAG_NORMAL, ZR_TAG_RUN, ZR_TAG_ESCAPE = 0, 1, 2
BIN_TAG_ZERO, BIN_TAG_ONE, BIN_TAG_TWO = 0, 1, 2
ZERO_RUN_MIN_LENGTH = 4
ZERO_RUN_LENGTH_K = 2
MIN_PARTITION_SIZE = 32
MAX_PARTITION_ORDER = 8
DRIFT_WINDOW = 256
MICRO_WINDOW = 96
FIXED_STENCILS = {0: (1,), 1: (1, -1), 2: (1, -2, 1), 3: (1, -3, 3, -1), 4: (1, -4, 6, -4, 1)}
FIR_TAPS, FIR_SHIFT = (3, -1), 2
LPC_SHIFT = 15
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
M64 = (1 << 64) - 1
STEREO_MODES = {"lr": STEREO_LR, "ms": STEREO_MS, "auto": STEREO_PER_BLOCK}
MAX_RICE_K = 31
INITIAL_SCAN_COUNT = 256  # samples scanned for a part's initial k (encoder.cpp:42)
INITIAL_MAX_K = 12  # the initial k's search ceiling (encoder.cpp:43)
MAX_STATIC_K = 15  # the static k's search ceiling (encoder.cpp:162)
MARGIN_DIVISOR = 20  # the 5% static and partition margins (encoder.cpp:57)
ESCAPE_K_OFFSET, ESCAPE_K_CAP = 3, 24  # escape above 1 << min(24, k + 3) (encoder.cpp:250)


class BadStream(Exception):
    """The stream breaks a wire rule or does not decode to its input."""


class Bits:
    """MSB-first reader over one block's payload, with 64-bit windows at
    every byte offset so that a read is a lookup and two shifts."""

    def __init__(self, data):
        self.nbits = len(data) * 8
        self.pos = 0
        raw = np.frombuffer(bytes(data) + bytes(8), dtype=np.uint8)
        win = np.zeros(len(data) + 1, dtype=np.uint64)
        for j in range(8):
            win |= raw[j : j + len(data) + 1].astype(np.uint64) << np.uint64(56 - 8 * j)
        self.win = win.tolist()

    def bits(self, k):
        if k == 0:
            return 0
        p = self.pos
        if p + k > self.nbits:
            raise BadStream("read past the block's payload")
        self.pos = p + k
        return ((self.win[p >> 3] << (p & 7)) & M64) >> (64 - k)

    def unary_ones(self, max_ones):
        """Count 1 bits up to the terminating 0, which is consumed."""
        count = 0
        while True:
            p = self.pos
            if p >= self.nbits:
                raise BadStream("unary code runs past the block's payload")
            off = p & 7
            x = (self.win[p >> 3] << off) & M64
            lead = 64 - ((~x) & M64).bit_length()  # leading ones
            usable = 64 - off
            if lead < usable:
                count += lead
                self.pos = p + lead + 1
                if self.pos > self.nbits or count > max_ones:
                    raise BadStream("bad unary code")
                return count
            count += usable
            self.pos = p + usable
            if count > max_ones:
                raise BadStream("unary code too long")

    def zero_padding(self):
        while self.pos & 7:
            if self.bits(1):
                raise BadStream("nonzero padding")


def zigzag(u):
    return (u >> 1) if not u & 1 else -((u >> 1) + 1)


def rice(r, k):
    if k > 31:
        raise BadStream("rice k above 31")
    q = r.unary_ones(0xFFFFFFFF >> k)
    return (q << k) | r.bits(k)


def stateless_k(total, count):
    if count == 0:
        return 0
    mean = (total + (count >> 1)) // count
    return 0 if mean <= 1 else min(31, (mean - 1).bit_length())


class StatefulK:
    """The adaptive-k state of one partition-free channel (rice.hpp:45-114)."""

    def __init__(self):
        self.prev = self.widx = self.midx = self.filled = self.wsum = self.large = self.zero = 0
        self.recent = [0] * DRIFT_WINDOW
        self.lflags = [0] * MICRO_WINDOW
        self.zflags = [0] * MICRO_WINDOW

    def adapt(self, total, count):
        if count == 0:
            return 0
        cur = total - self.prev
        self.prev = total
        mi = self.midx
        self.large -= self.lflags[mi]
        self.zero -= self.zflags[mi]
        if self.filled < DRIFT_WINDOW:
            self.filled += 1
        else:
            self.wsum -= self.recent[self.widx]
        self.recent[self.widx] = cur & 0xFFFFFFFF
        self.wsum += cur
        mean = (total + (count >> 1)) // count
        k = 0 if mean <= 1 else min(31, (mean - 1).bit_length())
        qb = 0 if k >= 31 else cur >> k
        il, iz = int(qb > 3), int(qb == 0)
        self.large += il
        self.zero += iz
        self.lflags[mi] = il
        self.zflags[mi] = iz
        bias = 0
        if mean > 0:
            if self.filled == DRIFT_WINDOW:
                lm = (self.wsum + 128) >> 8
            else:
                lm = (self.wsum + (self.filled >> 1)) // self.filled
            if lm * 3 > mean * 4:
                bias = 1
            elif lm * 4 + 3 < mean * 3:
                bias = -1
        if self.widx + 1 >= MICRO_WINDOW or self.filled >= MICRO_WINDOW:
            ws = MICRO_WINDOW if self.filled >= MICRO_WINDOW else self.filled
            if self.large * 4 >= ws * 3:
                bias = min(bias + 1, 1)
            elif self.zero * 5 >= ws * 4:
                bias = max(bias - 1, -1)
        self.midx = 0 if self.midx + 1 == MICRO_WINDOW else self.midx + 1
        self.widx = (self.widx + 1) & (DRIFT_WINDOW - 1)
        return max(0, min(31, k + bias))


def residual_segment(r, samples, k, mode, stateless):
    """One partition's residuals (block/decoder.cpp's segment decode)."""
    out = []
    if mode == MODE_STATIC:
        for _ in range(samples):
            out.append(zigzag(rice(r, k)))
        return out
    total = count = 0
    state = None if stateless else StatefulK()

    def step(u):
        nonlocal total, count, k
        total += u
        count += 1
        k = stateless_k(total, count) if stateless else state.adapt(total, count)

    if mode == MODE_RICE:
        for _ in range(samples):
            u = rice(r, k)
            out.append(zigzag(u))
            step(u)
        return out
    while len(out) < samples:
        tag = r.bits(2)
        if mode == MODE_ZERO_RUN:
            if tag == ZR_TAG_NORMAL:
                u = rice(r, k)
                out.append(zigzag(u))
                step(u)
            elif tag == ZR_TAG_RUN:
                run = rice(r, ZERO_RUN_LENGTH_K) + ZERO_RUN_MIN_LENGTH
                if run > samples - len(out):
                    raise BadStream("zero run past the partition")
                out.extend([0] * run)
                if stateless:
                    count += run
                    k = stateless_k(total, count)
                else:
                    for _ in range(run):
                        count += 1
                        k = state.adapt(total, count)
            elif tag == ZR_TAG_ESCAPE:
                zz = r.bits(32)
                out.append(zigzag(zz))
                step(zz)
            else:
                raise BadStream("bad zero-run tag")
        else:  # MODE_BIN
            if tag == BIN_TAG_ZERO:
                value, u = 0, 0
            elif tag in (BIN_TAG_ONE, BIN_TAG_TWO):
                mag = 1 if tag == BIN_TAG_ONE else 2
                sign = r.bits(1)
                value, u = (mag, 2 * mag) if sign == 0 else (-mag, 2 * mag - 1)
            else:
                u = rice(r, k)
                value = zigzag(u)
            out.append(value)
            step(u)
    return out


def restore(ptype, order, coeffs, res):
    """Closed-loop restore of one channel block's samples."""
    x = list(res)
    if ptype == PREDICTOR_FIXED:
        w = FIXED_STENCILS[order]
        for n in range(order, len(x)):
            x[n] = x[n] - sum(w[i] * x[n - i] for i in range(1, order + 1))
            if not INT32_MIN <= x[n] <= INT32_MAX:
                raise BadStream("fixed restore leaves int32")
        return x
    taps, shift, first = (FIR_TAPS, FIR_SHIFT, 2) if ptype == PREDICTOR_FIR else (coeffs, LPC_SHIFT, 0)
    for n in range(first, len(x)):
        acc = 0
        for i in range(1, min(len(taps), n) + 1):
            acc += taps[i - 1] * x[n - i]
        x[n] += acc >> shift
        if not INT32_MIN <= x[n] <= INT32_MAX:
            raise BadStream("restore leaves int32")
    return x


def channel_block(r, size):
    """Decode one channel block -> (list of samples, its plan: predictor
    type and order, partition order, each part's (mode, k), residuals)."""
    ptype, order = r.bits(8), r.bits(8)
    if ptype == PREDICTOR_LPC:
        if not 0 < order <= 32 or order >= size:
            raise BadStream("bad LPC order")
    elif ptype == PREDICTOR_FIR:
        if order != 2:
            raise BadStream("bad FIR order")
    elif ptype != PREDICTOR_FIXED or order > 4:
        raise BadStream("bad predictor")
    coeffs = []
    if ptype == PREDICTOR_LPC:
        for _ in range(order):
            c = r.bits(16)
            coeffs.append(c - 0x10000 if c >= 0x8000 else c)
    control = r.bits(8)
    if control & 0x10:
        raise BadStream("reserved control bit")
    flagged, porder, cmode = bool(control & 0x80), control & 0x0F, (control >> 5) & 0x03
    if flagged != (porder > 0) or porder > MAX_PARTITION_ORDER:
        raise BadStream("bad partition order")
    if porder and (size >> porder) < MIN_PARTITION_SIZE:
        raise BadStream("partition too small")
    nparts = 1 << porder
    base = size >> porder
    sizes = [base] * (nparts - 1) + [size - base * (nparts - 1)] if porder else [size]
    heads = [(r.bits(2), r.bits(5)) for _ in range(nparts)]
    if heads[0][0] != cmode:
        raise BadStream("control mode differs from the first partition's")
    res = []
    for (mode, k), psz in zip(heads, sizes):
        res.extend(residual_segment(r, psz, k, mode, porder > 0))
    r.zero_padding()
    plan = {"ptype": ptype, "order": order, "porder": porder, "heads": heads, "residuals": res}
    return restore(ptype, order, coeffs, res), plan


def parse_frame(data):
    """(header fields, block sizes, payload offsets, payload sizes) of a v3
    stream; raises BadStream on any broken rule."""
    if len(data) < HEADER_BYTES + 4:
        raise BadStream("stream shorter than a header")
    b = data[:HEADER_BYTES]
    hdr = {"sync": (b[0] << 8) | b[1], "version": b[2], "channels": b[3], "stereo_mode": b[4],
           "sample_rate": ((b[5] << 8) | b[6]) | (b[7] << 16), "bit_depth": b[8], "reserved": b[9]}
    if hdr["sync"] != SYNC_WORD or hdr["version"] != 3 or hdr["reserved"] != 0:
        raise BadStream(f"bad header {hdr}")
    count = int.from_bytes(data[HEADER_BYTES : HEADER_BYTES + 4], "big")
    table_end = HEADER_BYTES + 4 + 8 * count
    if count == 0 or table_end > len(data):
        raise BadStream("bad block count")
    tbl = np.frombuffer(data, dtype=">u4", count=2 * count, offset=HEADER_BYTES + 4).astype(np.int64)
    sizes, psizes = tbl[0::2], tbl[1::2]
    if (psizes == 0).any() or int(psizes.sum()) != len(data) - table_end:
        raise BadStream("payload sizes do not match the frame")
    offsets = table_end + np.concatenate([[0], np.cumsum(psizes)[:-1]])
    return hdr, sizes, offsets, psizes


def block_samples(data, hdr, offset, psize, size):
    """Decode one block -> (left, right) lists of samples and each coded
    channel's (samples, plan): left and right, or mid and side."""
    r = Bits(memoryview(data)[offset : offset + psize])
    stereo = hdr["channels"] == 2
    mid_side = stereo and hdr["stereo_mode"] == STEREO_MS
    if stereo and hdr["stereo_mode"] == STEREO_PER_BLOCK:
        flag = r.bits(8)
        if flag > 1:
            raise BadStream("bad per-block stereo flag")
        mid_side = flag == 1
    a, plan_a = channel_block(r, size)
    b, plan_b = channel_block(r, size) if stereo else (None, None)
    if r.pos != r.nbits:
        raise BadStream("trailing payload in a block")
    coded = [(a, plan_a)] + ([(b, plan_b)] if stereo else [])
    if mid_side:
        left = [m + ((s + (s & 1)) >> 1) for m, s in zip(a, b)]
        return left, [lv - s for lv, s in zip(left, b)], coded
    return a, b, coded


def check_frame(data, config, frames):
    """The whole stream's frame: header fields as the configuration states,
    the block table as the input's frames call for (full blocks, then the
    remainder). Returns the parsed frame; raises BadStream."""
    if not isinstance(data, (bytes, bytearray)) or not data:
        raise BadStream("no stream")
    hdr, sizes, offsets, psizes = parse_frame(data)
    want = {"channels": config["channels"], "sample_rate": config["sample_rate"], "bit_depth": config["bit_depth"],
            "stereo_mode": STEREO_MODES[config["stereo_mode"]] if config["channels"] == 2 else 0}
    got = {k: hdr[k] for k in want}
    if got != want:
        raise BadStream(f"header {got}, want {want}")
    full, tail = divmod(frames, MAX_BLOCK_SIZE)
    want_sizes = [MAX_BLOCK_SIZE] * full + ([tail] if tail else [])
    if sizes.tolist() != want_sizes:
        raise BadStream(f"block sizes {len(sizes)} blocks for {frames} frames")
    return hdr, sizes, offsets, psizes


# ---------------------------------------------------------------- the encoder's choices
_POW2 = np.int64(1) << np.arange(63, dtype=np.int64)


def _bit_length(x):
    """Bit length of each non-negative int64."""
    return np.searchsorted(_POW2, x, side="right").astype(np.int64)


def _mean_k(total, count):
    """(k, mean) of the adapter's running mean, elementwise (stateless_k)."""
    mean = (total + (count >> 1)) // count
    return np.where(mean <= 1, 0, np.minimum(MAX_RICE_K, _bit_length(np.maximum(mean - 1, 0)))), mean


def stateful_k_after(u):
    """The stateful adapter's k after each sample of a whole channel block
    (:class:`StatefulK`, over every sample at once): the state is a
    function of the codes alone."""
    n = len(u)
    c = np.arange(1, n + 1, dtype=np.int64)
    s0 = np.concatenate([[0], np.cumsum(u)])
    s = s0[1:]
    kb, mean = _mean_k(s, c)
    filled = np.minimum(c, DRIFT_WINDOW)
    wsum = s - s0[c - filled]  # the last `filled` codes
    lm = np.where(filled == DRIFT_WINDOW, (wsum + (DRIFT_WINDOW >> 1)) // DRIFT_WINDOW,
                  (wsum + (filled >> 1)) // filled)
    bias = np.where(mean > 0, np.where(lm * 3 > mean * 4, 1, np.where(lm * 4 + 3 < mean * 3, -1, 0)), 0)
    qb = np.where(kb >= MAX_RICE_K, 0, u >> np.minimum(kb, 62))
    lo = np.maximum(c - MICRO_WINDOW, 0)
    big = np.concatenate([[0], np.cumsum(qb > 3)])
    zer = np.concatenate([[0], np.cumsum(qb == 0)])
    large, zero = big[c] - big[lo], zer[c] - zer[lo]
    trig = c >= MICRO_WINDOW
    up = trig & (large * 4 >= MICRO_WINDOW * 3)
    down = trig & ~up & (zero * 5 >= MICRO_WINDOW * 4)
    bias = np.where(up, np.minimum(bias + 1, 1), np.where(down, np.maximum(bias - 1, -1), bias))
    return np.clip(kb + bias, 0, MAX_RICE_K)


class _Codes:
    """One candidate's residuals of a channel block, with what every
    order's costs share: codes, zero breaks and k-cost prefix sums."""

    def __init__(self, v):
        self.v = np.asarray(v, dtype=np.int64)
        self.n = n = len(self.v)
        self.u = (self.v << 1) ^ (self.v >> 63)  # zigzag
        self.absv = np.abs(self.v)
        self.z = self.v == 0
        self.idx = idx = np.arange(n, dtype=np.int64)
        self.last_nz = np.maximum.accumulate(np.where(self.z, -1, idx))
        self.next_nz = np.minimum.accumulate(np.where(self.z, n, idx)[::-1])[::-1]
        self.s0 = np.concatenate([[0], np.cumsum(self.u)])
        # (MAX_STATIC_K + 1, n + 1): prefix sums of u >> k
        self.ksums = np.concatenate([np.zeros((MAX_STATIC_K + 1, 1), np.int64),
                                     np.cumsum(self.u[None, :] >> np.arange(MAX_STATIC_K + 1)[:, None], axis=1)],
                                    axis=1)

    def k_costs(self, a, b, kmax):
        """Rice bits of parts [a, b) for every k in 0..kmax: (parts, kmax + 1)."""
        k = np.arange(kmax + 1)
        return (self.ksums[: kmax + 1, b] - self.ksums[: kmax + 1, a]).T + (k + 1) * (b - a)[:, None]

    def mode_bits(self, starts, ends, k_used):
        """Rice, bin and zero-run bits and has-run of each part, every
        sample coded with ``k_used``, zero runs cut at the part's edges."""
        u, idx = self.u, self.idx
        part = np.searchsorted(starts, idx, side="right") - 1
        first = np.maximum(self.last_nz + 1, starts[part])
        run_len = np.where(self.z, np.minimum(self.next_nz, ends[part]) - first, 0)
        long_run = self.z & (run_len >= ZERO_RUN_MIN_LENGTH)
        run_start = long_run & (idx == first)
        rice_b = np.where(k_used >= MAX_RICE_K, 0, u >> k_used) + 1 + k_used
        bin_b = np.where(self.absv == 0, 2, np.where(self.absv <= 2, 3, 2 + rice_b))
        escape = u > (np.int64(1) << np.minimum(k_used + ESCAPE_K_OFFSET, ESCAPE_K_CAP))
        run_b = 2 + ((run_len - ZERO_RUN_MIN_LENGTH) >> ZERO_RUN_LENGTH_K) + 1 + ZERO_RUN_LENGTH_K
        zr_b = np.where(run_start, run_b, np.where(long_run, 0, 2 + np.where(escape, 32, rice_b)))
        return [np.add.reduceat(x, starts) for x in (rice_b, bin_b, zr_b, run_start.astype(np.int64))]

    def whole(self):
        """Order 0: (bits of each mode, initial k, static k)."""
        zero, n = np.zeros(1, np.int64), np.array([self.n])
        initial_k = int(np.argmin(self.k_costs(zero, np.minimum(n, INITIAL_SCAN_COUNT), INITIAL_MAX_K)[0]))
        static = self.k_costs(zero, n, MAX_STATIC_K)[0]
        k_used = np.concatenate([[initial_k], stateful_k_after(self.u)[:-1]])
        rice_b, bin_b, zr_b, runs = (int(x[0]) for x in self.mode_bits(zero, n, k_used))
        return {"rice": rice_b, "bin": bin_b, "zr": zr_b, "has_run": runs > 0, "static": int(static.min()),
                "static_k": int(np.argmin(static)), "initial_k": initial_k}

    def parts(self, p):
        """Order p: each part's bits by mode, initial k and static bits and k."""
        base, nparts = self.n >> p, 1 << p
        starts = np.arange(nparts, dtype=np.int64) * base
        ends = np.concatenate([starts[1:], [self.n]])
        init_k = np.argmin(self.k_costs(starts, np.minimum(starts + INITIAL_SCAN_COUNT, ends), INITIAL_MAX_K), axis=1)
        static = self.k_costs(starts, ends, MAX_STATIC_K)
        part = np.minimum(self.idx // base, nparts - 1)
        pos = self.idx - starts[part]
        k_after, _ = _mean_k(self.s0[1:] - self.s0[starts[part]], pos + 1)  # stateless, inside the part
        k_used = np.where(pos == 0, init_k[part], np.concatenate([[0], k_after[:-1]]))
        rice_b, bin_b, zr_b, runs = self.mode_bits(starts, ends, k_used)
        return rice_b, bin_b, zr_b, runs > 0, static.min(axis=1), np.argmin(static, axis=1), init_k

    def best_bits(self, zero_run=True):
        """The least whole-block bits over the modes: the candidate's score."""
        w = self.whole()
        zr_eff = w["zr"] if (zero_run and w["has_run"]) else w["rice"]
        return min(w["rice"], w["static"], zr_eff, w["bin"])


def _pad8(bits):
    return bits + ((8 - (bits & 7)) & 7)


def choose_plan(codes, zero_run=True, partitioning=True):
    """The reference encoder's residual plan of one channel block's
    residuals: (partition order, [(mode, k)] of each part)."""
    w = codes.whole()
    best, mode, k = w["rice"], MODE_RICE, w["initial_k"]
    if zero_run and w["has_run"] and w["zr"] <= best:
        best, mode = w["zr"], MODE_ZERO_RUN
    if w["bin"] < best:
        best, mode = w["bin"], MODE_BIN
    if w["static"] < best:
        best, mode, k = w["static"], MODE_STATIC, w["static_k"]
    best_p, best_total, heads = 0, _pad8(best + 8 + 7), [(mode, k)]
    n = codes.n
    max_p = 0
    if partitioning and n >= MIN_PARTITION_SIZE:
        while max_p < MAX_PARTITION_ORDER and (n >> (max_p + 1)) >= MIN_PARTITION_SIZE:
            max_p += 1
    for p in range(1, max_p + 1):
        rice_b, bin_b, zr_b, has_run, static_b, static_k, init_k = codes.parts(p)
        bits, modes, ks = rice_b.copy(), np.full(len(rice_b), MODE_RICE), init_k.copy()
        if zero_run:
            take = has_run & (zr_b < bits)
            bits, modes = np.where(take, zr_b, bits), np.where(take, MODE_ZERO_RUN, modes)
        take = bin_b < bits
        bits, modes = np.where(take, bin_b, bits), np.where(take, MODE_BIN, modes)
        take = static_b <= bits + bits // MARGIN_DIVISOR  # static within 5% decodes faster
        bits, modes, ks = np.where(take, static_b, bits), np.where(take, MODE_STATIC, modes), np.where(take, static_k, ks)
        total = _pad8(int(bits.sum()) + 8 + 7 * (1 << p))
        # the first partitioned order within 5% of order 0 replaces it; later ones must be smaller
        if total < best_total or (best_p == 0 and total <= best_total + best_total // MARGIN_DIVISOR):
            best_p, best_total, heads = p, total, list(zip(modes.tolist(), ks.tolist()))
    return best_p, [(int(m), int(kk)) for m, kk in heads]


def fixed_residual(x, order):
    """Fixed predictor ``order``'s residuals of samples ``x`` (int64)."""
    r = x.copy()
    w = FIXED_STENCILS[order]
    r[order:] = sum(w[i] * x[order - i : len(x) - i] for i in range(order + 1))
    return r


def fir_residual(x):
    r = x.copy()
    r[2:] = x[2:] - ((FIR_TAPS[0] * x[1:-1] + FIR_TAPS[1] * x[:-2]) >> FIR_SHIFT)
    return r


def plan_fault(samples, plan, zero_run=True, partitioning=True):
    """Why one coded channel's plan is not the reference encoder's, or
    None. ``samples``: the coded channel (left or right, mid or side);
    ``plan``: what :func:`channel_block` read. The chosen predictor must
    score no worse than any fixed or FIR candidate (first minimum of
    bits * 4 + predictor type, in the table's order: fixed 0-4, FIR, then
    LPC; the LPC candidates' coefficients come from the encoder's float
    analysis and are not worked out again), and the residual plan must be
    :func:`choose_plan`'s."""
    x = np.asarray(samples, dtype=np.int64)
    chosen = _Codes(plan["residuals"])
    ptype, order = plan["ptype"], plan["order"]
    index = order if ptype == PREDICTOR_FIXED else 5 if ptype == PREDICTOR_FIR else 6
    key = chosen.best_bits(zero_run) * 4 + ptype
    for j in range(6):
        if j == index:
            continue
        res = fixed_residual(x, j) if j < 5 else fir_residual(x)
        other = _Codes(res).best_bits(zero_run) * 4 + (PREDICTOR_FIXED if j < 5 else PREDICTOR_FIR)
        if other < key or (other == key and j < index):
            name = f"fixed {j}" if j < 5 else "FIR"
            return f"predictor {ptype}/{order} scores {key}, {name} {other}"
    want = choose_plan(chosen, zero_run, partitioning)
    got = (plan["porder"], [tuple(h) for h in plan["heads"]])
    if got != want:
        return f"residual plan (order, [(mode, k)]) {got[0]} {got[1][:4]}, the encoder's {want[0]} {want[1][:4]}"
    return None


# ---------------------------------------------------------------- the judge
def check_frames(outputs, inputs, config):
    """Every stream's frame: (parsed frames by file, files wrong, notes)."""
    frames, notes = {}, []
    for i, (data, (left, _right)) in enumerate(zip(outputs, inputs)):
        try:
            frames[i] = check_frame(data, config, len(left))
        except BadStream as e:
            if len(notes) < 4:
                notes.append(f"file {i}: {e}")
    return frames, len(outputs) - len(frames), notes


def judge(outputs, inputs, config, sample, frames=None):
    """Hold the program's streams to the configuration's guarantees.

    ``outputs[i]``: the stream of file ``i`` (bytes; anything else counts
    as no stream); ``inputs[i]``: its (left, right) int32 arrays;
    ``sample``: (file, block) pairs to decode whole and whose plans to
    work out again; ``frames``: :func:`check_frames`' result, where the
    caller has it. Returns the numbers compared: ``files_wrong`` (streams
    whose frame is broken or whose header or block table disagrees with
    the input), ``blocks_wrong`` (sampled blocks that do not decode to the
    input's samples), ``plans_wrong`` (sampled blocks that decode to it
    but in which a channel is not coded with the reference encoder's
    plan), and what was judged, with the first faults found."""
    frames, files_wrong, notes = check_frames(outputs, inputs, config) if frames is None else frames
    blocks_wrong = plans_wrong = 0
    for i, blk in sample:
        try:
            if i not in frames:
                raise BadStream("its frame is broken")
            hdr, sizes, offsets, psizes = frames[i]
            if blk >= len(sizes):
                raise BadStream("no such block")
            lo, size = blk * MAX_BLOCK_SIZE, int(sizes[blk])
            left, right, coded = block_samples(outputs[i], hdr, int(offsets[blk]), int(psizes[blk]), size)
            want_l, want_r = inputs[i]
            if not np.array_equal(np.asarray(left, np.int64), want_l[lo : lo + size]):
                raise BadStream("left channel differs from the input")
            if right is not None and not np.array_equal(np.asarray(right, np.int64), want_r[lo : lo + size]):
                raise BadStream("right channel differs from the input")
        except BadStream as e:
            blocks_wrong += 1
            if len(notes) < 8:
                notes.append(f"file {i} block {blk}: {e}")
            continue
        faults = [f for f in (plan_fault(x, plan) for x, plan in coded) if f]
        if faults:
            plans_wrong += 1
            if len(notes) < 8:
                notes.append(f"file {i} block {blk}: {faults[0]}")
    return {"files_wrong": files_wrong, "blocks_wrong": blocks_wrong, "plans_wrong": plans_wrong,
            "files_judged": len(outputs), "blocks_judged": len(sample), "notes": notes}


def stereo_flags(data, frame):
    """Each block's per-block stereo flag (0 L/R, 1 mid/side), or None
    where the frame has no per-block flags."""
    hdr, _sizes, offsets, _psizes = frame
    if hdr["channels"] != 2 or hdr["stereo_mode"] != STEREO_PER_BLOCK:
        return None
    return np.frombuffer(data, dtype=np.uint8)[offsets]


def draw_sample(rng, batches, frames_of, frames, outputs, batches_judged, wave_blocks, chunk_blocks, per_stereo):
    """(file, block) pairs to judge, spread over what can fail apart:
    ``batches_judged`` of ``batches`` (each a list of files, in the order
    they were handed over), and in each one block drawn from every chunk
    of ``chunk_blocks`` full blocks of every wave (waves of at most
    ``wave_blocks`` full blocks, filled greedily by whole files in order,
    as the pool fills them), the last block of every file (its tail, or
    its last full block), and further blocks until each stereo route
    (L/R and mid/side blocks, read from the streams' flags) has at least
    ``per_stereo``. ``frames_of[i]``: file ``i``'s frames; ``frames``:
    :func:`check_frames`' parsed frames."""
    pairs = set()
    for g in sorted(int(x) for x in rng.choice(len(batches), size=min(batches_judged, len(batches)), replace=False)):
        files = batches[g]
        waves, cur = [], []
        for i in files:
            nfull = frames_of[i] // MAX_BLOCK_SIZE
            if not nfull:
                continue
            if cur and len(cur) + nfull > wave_blocks:
                waves.append(cur)
                cur = []
            cur.extend((i, b) for b in range(nfull))
        if cur:
            waves.append(cur)
        picked = set()
        for wave in waves:
            for c0 in range(0, len(wave), chunk_blocks):
                chunk = wave[c0 : c0 + chunk_blocks]
                picked.add(chunk[int(rng.integers(len(chunk)))])
        picked.update((i, -(-frames_of[i] // MAX_BLOCK_SIZE) - 1) for i in files if frames_of[i])
        flags = {i: stereo_flags(outputs[i], frames[i]) for i in files if i in frames}
        for route in (0, 1):
            have = sum(1 for i, b in picked if flags.get(i) is not None and flags[i][b] == route)
            spare = [(i, int(b)) for i in files if flags.get(i) is not None
                     for b in np.flatnonzero(flags[i] == route) if (i, int(b)) not in picked]
            extra = min(max(per_stereo - have, 0), len(spare))
            if extra:
                picked.update(spare[j] for j in rng.choice(len(spare), size=extra, replace=False))
        pairs |= picked
    return sorted(pairs)
