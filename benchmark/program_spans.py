"""The port's own spans over a run's window (``lac_tpu_torch.utils.debug``),
for the per-layer readers that read them. The port records spans while a
``torch.profiler`` profile runs, so a traced window holds them. A port that
records no spans gives None, and so does every reader of them."""

from .record import share_pct


def window_spans(run):
    """The program's spans that overlap the run's window, or None."""
    from lac_tpu_torch.utils import debug

    read = getattr(debug, "spans", None)
    return read(*run.window) if read is not None else None


def union_pct(run, pick):
    """The union of the window's spans that ``pick`` takes, as a share of
    the window (%); None where it takes none."""
    ivs = [(s.t0, s.t1) for s in window_spans(run) or () if pick(s)]
    return share_pct(ivs, run.window) if ivs else None

