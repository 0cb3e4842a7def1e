"""The traced sub-window: torch.profiler over a bounded stretch of the
cell's own work, read back from its Chrome trace.

`Profiled` wraps the work in ``torch.profiler.profile`` (CPU and CUDA
activities) inside one ``cogbench.traced`` annotation; the drivers mark
their calls into the system with further annotations (``cogbench.call``,
``cogbench.sample``, ``cogbench.step``). `Trace` holds what the metrics
read: the device's operations (kernels, copies, sets) as (name, start
us, duration us), the host's events, and the traced window.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

WINDOW = "cogbench.traced"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A device operation's name without ``void``, an anonymous
    namespace, template arguments and parameters: ``void
    ed::fused_step_kernel<false, 0>(int const*, ...)`` is
    ``ed::fused_step_kernel``; a copy keeps its direction."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


class Trace:
    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace has no cogbench.traced window")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0)))
             for e in events if e.get("cat") in _DEVICE_CATS
             and e.get("ph") == "X"), key=lambda x: x[1])
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                     for e in events if e.get("cat") in _HOST_CATS
                     and e.get("ph") == "X" and e.get("name") != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self, part: str) -> list:
        """(start us, duration us) of each device operation whose name
        holds ``part``, in start order."""
        return [(ts, d) for name, ts, d in self.device if part in name]

    def busy_intervals(self) -> list:
        """The union of the device's operations inside the window, as
        merged (start, end) intervals in us."""
        out = []
        for _, ts, d in self.device:
            a, b = max(ts, self.t0), min(ts + d, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the ``k`` device operations that took the
        most time in all, summed over their launches (a kernel's name
        without its template arguments and parameters)."""
        tot = {}
        for name, _, d in self.device:
            name = short_name(name)
            tot[name] = tot.get(name, 0.0) + d * 1e-6
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds] for the ``k`` longest gaps
        between the device's operations in the window: the innermost host
        event open at the gap's middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            open_ = [(d, n) for n, ts, d in self.host if ts <= mid <= ts + d]
            what = min(open_)[1] if open_ else "no host event"
            out.append([what, (b - a) * 1e-6])
        return out


class Profiled(contextlib.AbstractContextManager):
    """``with Profiled(torch, cuda) as p: ...`` profiles the block; then
    ``p.trace`` is its `Trace`. The Chrome trace is written to a temporary
    directory (under TMPDIR) and removed once read."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.trace = None

    def __enter__(self):
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        self.prof = self.torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.win = self.torch.profiler.record_function(WINDOW)
        self.win.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.torch.cuda.synchronize()
        self.win.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self.prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh)
            if isinstance(events, dict):
                events = events.get("traceEvents", [])
            self.trace = Trace(events)
        return False
