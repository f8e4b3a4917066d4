"""The traced window: torch.profiler over the window, read into device
intervals, kernel families, the busy time and the breakdown.

The window is marked by a ``gpbench:window`` span, so its bounds are on the
profiler's own clock; every device interval (kernels, copies, fills) is
clipped to it.  Busy time is the union of the intervals, so work that
overlaps on several streams counts once.  Idle gaps are named by the
innermost ``gpbench:*`` span (the harness's own spans around each call
into the program) and the innermost host operation open at the gap's
middle.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .stats import intervals_union

WINDOW_SPAN = "gpbench:window"

#: kernel families by the CUDA function names of the program's libraries:
#: a main kernel names its family and counts one call of it; a helper
#: belongs to the family of the main kernel launched just before it
#: ("after") or just after it ("before")
MAIN_KERNELS = (
    ("fused_cg_product", "B3"),
    ("kernel_matmul_grad_kernel", "grad"),
    ("kernel_matmul_bf16_kernel", "B1"),
    ("kernel_matmul_kernel", "B1"),
)
PART_KERNELS = (("advance_bf16_kernel", "B3"), ("advance_kernel", "B3"))
HELPERS_AFTER = ("fold_partials_kernel", "fold_chunks_kernel", "cg_epilogue_bf16_kernel")
HELPERS_BEFORE = ("norms_bf16_kernel",)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list  # (name, start_s, end_s), window-relative, by start
    host: list  # (name, start_s, end_s) of spans and of host ops over 50 us

    def families(self) -> dict:
        """{family: {"calls": int, "seconds": float}} over the window."""
        out = {}
        pending_before = 0.0
        last = None
        for name, s, e in self.device:
            fam = _main(name)
            if fam is not None:
                rec = out.setdefault(fam, {"calls": 0, "seconds": 0.0})
                rec["calls"] += 1
                rec["seconds"] += (e - s) + pending_before
                pending_before = 0.0
                last = fam
                continue
            part = _lookup(name, PART_KERNELS)
            if part is not None:
                out.setdefault(part, {"calls": 0, "seconds": 0.0})["seconds"] += e - s
                continue
            if any(h in name for h in HELPERS_BEFORE):
                pending_before += e - s
            elif last is not None and any(h in name for h in HELPERS_AFTER):
                out[last]["seconds"] += e - s
        return out

    def device_ops(self, top: int = 10) -> list:
        totals = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), v] for n, v in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        spans = sorted((s, e) for _, s, e in self.device)
        gaps, cursor = [], 0.0
        for s, e in spans:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.window_s:
            gaps.append((cursor, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (a + b)), b - a] for a, b in gaps[:top]]

    def _host_at(self, t: float) -> str:
        span, op = None, None
        for name, s, e in self.host:
            if s <= t <= e:
                if name.startswith("gpbench:") and name != WINDOW_SPAN:
                    if span is None or s >= span[1]:
                        span = (name, s)
                elif not name.startswith("gpbench:"):
                    if op is None or s >= op[1]:
                        op = (name, s)
        parts = [p[0] for p in (span, op) if p is not None]
        return _short(" / ".join(parts) if parts else "no host span")


def _lookup(name, table):
    for key, fam in table:
        if key in name:
            return fam
    return None


def _main(name: str):
    return _lookup(name, MAIN_KERNELS)


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


class Window:
    """Profiles the window when ``enabled``; ``trace`` holds the reading
    after ``stop``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.span = None
        self.trace = None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self):
        if not self.enabled:
            return
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.trace = read(self.prof)
        self.prof = None


def read(prof) -> Trace | None:
    events = list(prof.profiler.kineto_results.events())
    host, device = [], []
    w0 = w1 = None
    for ev in events:
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a span's range on the device's timeline is no device work
            annotation = getattr(ev, "is_user_annotation", None)
            if not (name.startswith("gpbench:") or (annotation is not None and annotation())):
                device.append((name, start, end))
        else:
            if name == WINDOW_SPAN:
                w0, w1 = start, end
            elif name.startswith("gpbench:") or end - start > 50_000:
                host.append((name, start, end))
    if w0 is None:
        return None
    scale = 1e-9
    dev = sorted(((n, (max(s, w0) - w0) * scale, (min(e, w1) - w0) * scale)
                  for n, s, e in device if e > w0 and s < w1), key=lambda x: x[1])
    hst = [(n, (s - w0) * scale, (e - w0) * scale) for n, s, e in host if e > w0 and s < w1]
    window_s = (w1 - w0) * scale
    busy = intervals_union([(s, e) for _, s, e in dev])
    return Trace(window_s=window_s, busy_s=busy, device=dev, host=hst)


def _ns(ev, what: str) -> int:
    ns = getattr(ev, f"{what}_ns", None)
    if ns is not None:
        return int(ns())
    return int(getattr(ev, f"{what}_us")() * 1000)


def spans(enabled: bool):
    """The harness's span factory: ``gpbench:<name>`` around each call into
    the program in a traced run, nothing otherwise."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    return lambda name: torch.profiler.record_function(f"gpbench:{name}")
