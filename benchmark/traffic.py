"""The one general generator: it reads a traffic mix (a JSON file of
parameters under ``benchmark/traffic/``) and a configuration, and makes
the run's inputs from ``--seed``.

Every seed gets the same set of sizes, in another order: track lengths
are drawn once from the mix's ``layout_seed``; the run's seed orders the
batches and makes the content. So runs on different seeds do the same
amount of work.

Mix keys of the ``"pooled"`` driver (closed loop: batches handed to
``pool.encode_pooled`` one after another): ``track_s`` [lo, hi] (uniform
lengths in seconds), ``batch_blocks`` (tracks per batch: the whole number
nearest ``batch_blocks`` over a track's mean full blocks at the
configuration's rate), ``distinct_batches`` (made at set-up and cycled
through in the window, in an order drawn from the seed), ``recipes``
(track ``i`` of a batch takes ``recipes[i % len(recipes)]``, see
:mod:`.signals`), ``layout_seed``, ``judge`` (the sample the reference
judges: ``batches`` of the window's batches, one block from every chunk
of ``chunk_blocks`` of every wave of at most ``wave_blocks``, every
file's last block, ``per_stereo`` blocks of each stereo route at least;
see ``reference.draw_sample``).
"""

import numpy as np

from . import signals

N = 16384  # samples per channel in a full block


def _u64(*words):
    """A 64-bit seed from integers of any size (the driver's seeds exceed 32 bits)."""
    return int(np.random.SeedSequence([int(w) & (2**64 - 1) for w in words]).generate_state(1, np.uint64)[0])


def rng(*words):
    return np.random.default_rng(_u64(*words))


def tracks_per_batch(mix, config):
    mean_blocks = 0.5 * sum(mix["track_s"]) * config["sample_rate"] / N
    return max(1, int(round(mix["batch_blocks"] / mean_blocks)))


def _lengths(r, span_s, count, rate):
    lo, hi = span_s
    return [int(s * rate) for s in r.uniform(lo, hi, size=count)]


def pooled_layout(mix, config):
    """(batches, warm): the frame counts of each distinct batch's tracks,
    and of the warm-up batch, fixed by the mix's layout seed."""
    r = rng(mix["layout_seed"])
    per = tracks_per_batch(mix, config)
    batches = [_lengths(r, mix["track_s"], per, config["sample_rate"]) for _ in range(mix["distinct_batches"])]
    warm = _lengths(r, mix["track_s"], per, config["sample_rate"])
    return batches, warm


def recipe_of(mix, i):
    recipes = mix["recipes"]
    return recipes[i % len(recipes)]


def make_tracks(mix, config, frames_list, seed, tag, device):
    """Host int32 (left, right) pairs for tracks of ``frames_list``, their
    content made on ``device`` from (seed, tag, track)."""
    return [signals.make_track(recipe_of(mix, i), frames, config["sample_rate"], config["bit_depth"],
                               _u64(seed, *tag, i), device)
            for i, frames in enumerate(frames_list)]


def batch_order(seed, count):
    """The order in which a run visits the distinct batches."""
    return [int(i) for i in rng(seed, 11).permutation(count)]


def pcm_bytes(frames, config):
    """PCM bytes of ``frames`` frames at the configuration's width."""
    return frames * config["channels"] * (config["bit_depth"] // 8)
