"""The profiler's trace of a window, reduced to what the metric readers
read: the device's kernels and copies, the union of their intervals, the
idle gaps between them with what the host was doing, and device time by
kernel family.

The family table is a frozen copy of the repository's profiling tool's
grouping (kernel-name fragment -> family, first match wins). The busy time
is the union of the device intervals, never their sum: kernels on cuDNN's
own streams overlap the others, and a sum counts that time twice.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

FAMILIES = (
    ("conv_block_bwd_kernel", "K2 conv_block_bwd_kernel"),
    ("conv_block_bwd_tc_kernel", "K2 conv_block_bwd_tc_kernel"),
    ("conv_block_fwd_kernel", "K1 conv_block_fwd_kernel"),
    ("conv_block_fwd_tc_kernel", "K1 conv_block_fwd_tc_kernel"),
    ("conv_stack_bwd_kernel", "K4 conv_stack_bwd_kernel"),
    ("conv_stack_bwd_tc_kernel", "K4 conv_stack_bwd_tc_kernel"),
    ("conv_stack_fwd_kernel", "K4 conv_stack_fwd_kernel"),
    ("conv_stack_fwd_tc_kernel", "K4 conv_stack_fwd_tc_kernel"),
    ("reduce_partials_kernel", "reduce_partials_kernel"),
    ("clip_noise_kernel", "K3 clip_noise_kernel"),
    ("max_pool", "library max pool fwd/bwd"),
    ("conv_depthwise2d", "library depthwise convs"),
    ("softmax", "softmax"),
    ("nchwToNhwc", "cuDNN layout transforms"),
    ("nhwcToNchw", "cuDNN layout transforms"),
    ("tensorTransform", "cuDNN layout transforms"),
    ("cudnn", "library convolutions (cuDNN)"),
    ("implicit_convolve", "library convolutions (cuDNN)"),
    ("nvjet", "dense GEMMs (cuBLAS)"),
    ("gemm", "dense GEMMs (cuBLAS)"),
    ("cutlass", "dense GEMMs (cuBLAS)"),
    ("reduce_kernel", "PyTorch reductions"),
    ("mbtopk", "torch.topk"),
    ("Sort", "torch.sort"),
    ("roll_cuda_kernel", "torch.roll"),
    ("_scatter_gather", "scatter and gather"),
    ("Memcpy", "copies and casts"),
    ("copy_kernel", "copies and casts"),
    ("poisson", "torch.poisson"),
    ("distribution", "random draws"),
    ("index", "indexing"),
    ("elementwise", "PyTorch elementwise"),
)

# the harness's own spans carry this prefix
SPAN_PREFIX = "bench."


def family(name: str) -> str:
    for fragment, fam in FAMILIES:
        if fragment in name:
            return fam
    return "everything else"


def _kind(ev) -> str:
    """'kernel', 'copy' (memcpy / memset), 'annotation' (a span's mirror
    on the device timeline, no device work) or 'host'."""
    dev = str(ev.device_type())
    if "CUDA" not in dev:
        return "host"
    act = str(ev.activity_type()).lower() if hasattr(
        ev, "activity_type") else ""
    name = ev.name()
    if "annotation" in act or name.startswith(SPAN_PREFIX):
        return "annotation"
    if "memcpy" in act or "memset" in act or name.startswith(
            ("Memcpy", "Memset")):
        return "copy"
    return "kernel"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                               float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The events of one profiled window, in microseconds."""

    def __init__(self, events, window_span: str):
        self.kernels: List[Tuple[str, float, float]] = []
        self.copies: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        w = None
        for ev in events:
            kind = _kind(ev)
            if kind == "annotation":
                continue
            s = ev.start_ns() / 1e3
            e = s + ev.duration_ns() / 1e3
            name = ev.name()
            if kind == "kernel":
                self.kernels.append((name, s, e))
            elif kind == "copy":
                self.copies.append((name, s, e))
            else:
                if name == window_span:
                    w = (s, e)
                self.host.append((name, s, e))
        if w is None:
            raise RuntimeError(f"the trace holds no span {window_span!r}")
        self.t0, self.t1 = w
        clip = lambda lst: [(n, max(s, self.t0), min(e, self.t1))
                            for n, s, e in lst if e > self.t0 and s < self.t1]
        self.kernels = clip(self.kernels)
        self.copies = clip(self.copies)
        self.busy = _union([(s, e) for _, s, e in self.kernels + self.copies])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def family_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            out[family(name)] += (e - s) / 1e3
        for name, s, e in self.copies:
            out["copies and casts"] += (e - s) / 1e3
        return dict(out)

    def kernel_ms(self, fragment: str) -> Tuple[float, int]:
        """Total ms and count of the kernels whose name holds
        ``fragment``."""
        hits = [(e - s) for n, s, e in self.kernels if fragment in n]
        return sum(hits) / 1e3, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels + self.copies:
            by[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time inside the window, summed by what the host was
        doing when each gap began: the innermost harness span and the
        innermost host operation open at that moment."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(((s, e, name) for name, s, e in self.host
                        if name.startswith(SPAN_PREFIX)), key=lambda t: t[0])
        ops = sorted(((s, e, name) for name, s, e in self.host
                      if not name.startswith(SPAN_PREFIX)
                      and not name.startswith("cuda")),
                     key=lambda t: t[0])
        span_starts = [s for s, _, _ in spans]
        op_starts = [s for s, _, _ in ops]
        by: Dict[str, float] = defaultdict(float)
        for gs, ge in gaps:
            where = (f"{_innermost(spans, span_starts, gs)} / "
                     f"{_innermost(ops, op_starts, gs)}")
            by[where] += (ge - gs) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _innermost(intervals, starts, t: float) -> str:
    """The name of the latest-starting interval that holds t (``starts``
    the intervals' sorted starts)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(intervals[max(0, i - 4000):i]):
        if e >= t:
            return name
    return "none"


def events_of(prof) -> list:
    """The raw kineto events of a finished ``torch.profiler.profile``."""
    return prof.profiler.kineto_results.events()
