"""kernels.wide_parts_pct (program counter): of the parts that kernel 10
(``partition_cost_sums``) summed in the window's plans, full width and
probe, the share whose codes sum to 2^31 or more, which it sums the 64-bit
way: sum of ``wide`` over sum of ``parts`` of the port's ``meta_fetch``
spans (each the tally of one chunk's plan batches, padded rows included)
(%). None where no span carries them (a port without the tally, or plans
without partitions)."""

from benchmark.program_spans import window_spans


def read(run):
    spans = [s for s in window_spans(run) or () if s.name == "meta_fetch" and "parts" in s.attrs]
    parts = sum(s.attrs["parts"] for s in spans)
    return 100.0 * sum(s.attrs["wide"] for s in spans) / parts if parts else None
