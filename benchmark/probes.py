"""The benchmark's wrappers around calls into the program's layers. They
live only here: the program runs unchanged, and a run of the port outside
the benchmark pays nothing for them.

- Spans: host-clock intervals of ``pool.run_group_wave`` (label "wave")
  and ``FrameEncoder.encode_frame`` (label "finish", the per-file host
  finish that ``encode_pooled`` runs),
  besides the spans the drivers record themselves.
- Launches: the operands of every call of the port's kernel functions
  (``ops/cuda_kernels``, wherever a module of the package holds them) on
  a card. A call made while a CUDA graph is captured belongs to that graph
  (``plan_graphs._capture``), and each replay of the graph counts it
  again; calls outside a capture count once. Counting is on while
  ``tallying`` is set (the traced window).
"""

import sys
import threading
import time

from . import yardstick


def _param(name, args, kwargs):
    if name == "k_cost_sums":
        head = args[1] if len(args) > 1 else kwargs.get("head")
        return int(head or 0)
    if name == "k_cost_partition_sums":
        return int(args[1] if len(args) > 1 else kwargs["max_p"])
    if name == "partition_cost_sums":
        return int(args[4] if len(args) > 4 else kwargs["max_p"])
    return 0


class Probes:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans = {"wave": [], "finish": [], "batch": []}  # "batch": a driver's own calls
        self.tallying = False
        self.least_s = {}  # function -> least time of its counted launches
        self.launches = {}  # function -> counted launches
        self._tls = threading.local()
        self._undo = []

    # ------------------------------------------------------------ spans
    def span(self, label, t0, t1):
        with self.lock:
            self.spans.setdefault(label, []).append((t0, t1))

    def _spanned(self, label, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.span(label, t0, time.perf_counter())

        return wrapped

    # ------------------------------------------------------------ launches
    def _count(self, records):
        with self.lock:
            for name, least, k in records:
                self.least_s[name] = self.least_s.get(name, 0.0) + least
                self.launches[name] = self.launches.get(name, 0) + k

    def _kernel(self, name, fn):
        import torch

        def wrapped(*args, **kwargs):
            x = args[0]
            if getattr(self._tls, "inside", False) or x.device.type != "cuda":
                return fn(*args, **kwargs)  # the plain version, or a call the outer one accounts for
            param = _param(name, args, kwargs)
            self._tls.inside = True
            try:
                out = fn(*args, **kwargs)
            finally:
                self._tls.inside = False
            rec = (name, yardstick.least_s(name, x.shape[0], x.shape[1], param), 1)
            if torch.cuda.is_current_stream_capturing():
                captured = getattr(self._tls, "capture", None)
                if captured is not None:
                    captured.append(rec)
            elif self.tallying:
                self._count([rec])
            return out

        return wrapped

    def _capture(self, orig):
        def wrapped(dev, run, prefill=None):
            recorded = []
            self._tls.capture = recorded
            try:
                captured = orig(dev, run, prefill)
            finally:
                self._tls.capture = None
            per = {}
            for name, least, k in recorded:
                s, c = per.get(name, (0.0, 0))
                per[name] = (s + least, c + k)
            records = [(name, s, c) for name, (s, c) in per.items()]
            replay = captured.replay

            def counted_replay():
                if self.tallying:
                    self._count(records)
                return replay()

            captured.replay = counted_replay
            return captured

        return wrapped

    # ------------------------------------------------------------ install
    def _patch(self, owner, attr, value):
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def install(self):
        """Wrap the program's entry points; call before its first capture."""
        from lac_tpu_torch import encoder, plan_graphs, pool
        from lac_tpu_torch.ops import cuda_kernels

        self._patch(pool, "run_group_wave", self._spanned("wave", pool.run_group_wave))
        self._patch(encoder.FrameEncoder, "encode_frame", self._spanned("finish", encoder.FrameEncoder.encode_frame))
        self._patch(plan_graphs, "_capture", self._capture(plan_graphs._capture))
        holders = [m for key, m in list(sys.modules.items()) if key.split(".")[0] == "lac_tpu_torch" and m is not None]
        for name in yardstick.FUNCTIONS:
            orig = getattr(cuda_kernels, name)
            wrapped = self._kernel(name, orig)
            for mod in holders:
                if getattr(mod, name, None) is orig:
                    self._patch(mod, name, wrapped)
        return self

    def uninstall(self):
        while self._undo:
            owner, attr, value = self._undo.pop()
            setattr(owner, attr, value)
