"""The benchmark's content recipes, frozen: stereo PCM made from a seed.

Copies of lac_tpu_torch/profile_encode.py:79-126 (``gliding_stereo``,
``filtered_noise_stereo``, the recipes of chip_smoke.py's files), moved
from numpy's RandomState to torch so that they run on the card: the
float64 arithmetic is the same, the noise comes from a ``torch.Generator``
on the tensors' device. The same seed on the same kind of device gives the
same samples.
"""

import math

import torch


def _shift1(x):
    return torch.cat([x.new_zeros(1), x[:-1]])


def _to_pcm(x, depth):
    scale, lim = (1, 1 << 15) if depth == 16 else (256, 1 << 23)
    # float -> int32 truncates toward zero, as numpy's astype does
    return torch.clamp(x * scale, -lim, lim - 1).to(torch.int32)


def gliding_stereo(frames, sample_rate, depth, gen):
    """Music-like gliding sines under a slow envelope (certain-LR,
    certain-MS and uncertain stereo blocks all occur)."""
    dev = gen.device
    f64 = torch.float64
    t = torch.arange(frames, dtype=f64, device=dev) / sample_rate
    sig = torch.zeros(frames, dtype=f64, device=dev)
    for f0, f1, amp in ((220, 440, 0.3), (880, 860, 0.2), (3520, 3300, 0.08)):
        sig += amp * torch.sin(2 * math.pi * torch.cumsum(torch.linspace(f0, f1, frames, dtype=f64, device=dev), 0)
                               / sample_rate)
    noise = torch.randn(frames, dtype=f64, device=dev, generator=gen)
    for _ in range(2):
        noise = 0.5 * noise + 0.5 * _shift1(noise)
    sig += 0.05 * noise
    env = 0.5 * (1 + torch.sin(2 * math.pi * 0.37 * t))
    return _to_pcm(sig * env * 28000, depth), _to_pcm(torch.roll(sig, 7) * env * 26500, depth)


def filtered_noise_stereo(frames, sample_rate, depth, gen):
    """Low-passed noise and no tone: white noise through the moving blend
    (six passes) at music level under the same envelope. The right channel
    is the left delayed by three samples plus noise of its own whose level
    swells and fades, so correlated and independent stretches both occur."""
    dev = gen.device
    f64 = torch.float64
    t = torch.arange(frames, dtype=f64, device=dev) / sample_rate

    def lowpassed(x, passes):
        for _ in range(passes):
            x = 0.5 * x + 0.5 * _shift1(x)
        return x

    base = lowpassed(torch.randn(frames, dtype=f64, device=dev, generator=gen), 6)
    own = lowpassed(torch.randn(frames, dtype=f64, device=dev, generator=gen), 2) * 0.5 * (
        1 + torch.sin(2 * math.pi * 0.11 * t))
    env = 0.25 + 0.75 * 0.5 * (1 + torch.sin(2 * math.pi * 0.37 * t))
    return (_to_pcm(base * env * 24000, depth),
            _to_pcm((0.9 * torch.roll(base, 3) + 0.6 * own) * env * 24000, depth))


RECIPES = {"tonal": gliding_stereo, "noise": filtered_noise_stereo}


def make_track(recipe, frames, sample_rate, depth, seed, device):
    """One stereo track as host int32 arrays (what the port's WAV reader
    gives), made on ``device`` from ``seed`` (any integer below 2^64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    left, right = RECIPES[recipe](frames, sample_rate, depth, gen)
    return left.cpu().numpy(), right.cpu().numpy()
