"""The traced run: the profiler over the window and, apart, over set-up's
build of the fixed graph, and the benchmark's own recorder of the
program's kernel launches.

The recorder wraps, from the benchmark's side, the wrapper function that
launches each kernel (``roofline/<kernel>.py``'s ``WRAPS``) and keeps
the bytes and operations each launch's inputs need (that file's
``work``), tallied apart for each section; the program is not edited.
It is installed in the traced run only.  The profiler (``torch.profiler``:
CPU and CUDA activities over the window, CUDA alone over set-up) gives
each section's device intervals, from which come the busy time, the time
of each operation, each kernel's device time and, in the window, the
idle gaps.
"""

from __future__ import annotations

import importlib
import time
import weakref

import numpy as np

from colorbench import peaks, spec, stats

WINDOW = "colorbench.window"
# the recorder's sections besides the window: set-up's build of the fixed
# graph and its colourers (profiled as a ``DeviceSection``), and its warm
# jobs, tallied and never read, so that the memo's per-tensor values (K1's
# row degrees) are worked out there and not in the window
SETUP_GRAPH = "colorbench.setup.graph"
SETUP_WARM = "colorbench.setup.warm"


class Memo:
    """Per-tensor values (row degrees, real neighbour slots) computed once
    on the card for as long as the tensor (or the tensor a view is cut
    from) lives."""

    def __init__(self):
        self._values: dict = {}

    def get(self, tensor, key, fn):
        base = tensor._base if tensor._base is not None else tensor
        k = (id(base), tensor.data_ptr(), tuple(tensor.shape), tuple(tensor.stride()), key)
        hit = self._values.get(k)
        if hit is not None and hit[0]() is base:
            return hit[1]
        value = fn()
        self._values[k] = (weakref.ref(base), value)
        return value


class Recorder:
    """Each launch's (bytes, operations) of the named kernels, from the
    benchmark's own wrapper around the program's launch functions,
    tallied under the section open at the launch (none outside them)."""

    def __init__(self, kernels):
        self.kernels = {k: spec.roofline(k) for k in kernels}
        self.sections: dict[str, dict] = {}
        self.launches = None  # the open section's tally
        self.memo = Memo()
        self._saved = []

    def install(self):
        for name, roof in self.kernels.items():
            mod = importlib.import_module(roof.WRAPS[0])
            orig = getattr(mod, roof.WRAPS[1])

            def wrapped(*args, _orig=orig, _roof=roof, _name=name, **kwargs):
                out = _orig(*args, **kwargs)
                if self.launches is not None:
                    self.launches[_name].append(_roof.work(args, kwargs, self.memo))
                return out

            setattr(mod, roof.WRAPS[1], wrapped)
            self._saved.append((mod, roof.WRAPS[1], orig))
        return self

    def uninstall(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def start(self, section: str) -> None:
        """Tally the launches from here on under ``section``, anew."""
        self.launches = self.sections[section] = {k: [] for k in self.kernels}

    def bound_s(self, kernel: str, section: str = WINDOW) -> tuple[int, float]:
        """(launches, the summed least time of those launches) in a section."""
        import torch

        rows = self.sections.get(section, {}).get(kernel, [])
        if not rows:
            return 0, 0.0
        flat = [x for r in rows for x in r]
        dev = [x for x in flat if isinstance(x, torch.Tensor)]
        vals = iter(torch.stack([d.to(torch.float64) for d in dev]).tolist()) if dev else None
        nums = [next(vals) if isinstance(x, torch.Tensor) else float(x) for x in flat]
        roof = self.kernels[kernel]
        total = sum(peaks.bound_s(b, o, roof.OPS_PER_S) for b, o in zip(nums[::2], nums[1::2]))
        return len(rows), total


def _start_profiler(host: bool = True) -> None:
    """A kineto session over CPU and CUDA activities, read by its raw
    events: ``torch.profiler.profile`` would also build a Python object
    an event, which takes minutes over a long window.  ``host=False``
    records the CUDA activities alone where there is a card: no host
    operator, so the host pays little for the session."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import profiler as ap

    cuda = torch.cuda.is_available()
    acts = {torch.profiler.ProfilerActivity.CPU} if host or not cuda else set()
    if cuda:
        acts.add(torch.profiler.ProfilerActivity.CUDA)
    cfg = ap.ProfilerConfig(ap.ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    ap._prepare_profiler(cfg, acts)
    ap._enable_profiler(cfg, acts)


def _stop_profiler():
    from torch.autograd import profiler as ap

    return ap._disable_profiler().events()


def _annotation(e) -> bool:
    """A range on the device's timeline that marks host ranges, not work
    (torch 2.11's events have no ``activity_type``: the name tells)."""
    kind = getattr(e, "activity_type", None)
    return ("annotation" in str(kind() if callable(kind) else kind).lower()
            or e.name().startswith("colorbench."))


def _device_work(intervals, kernel_names: dict[str, str]):
    """(busy seconds, each kernel's device seconds, the top ten device
    operations) of device intervals (start ns, end ns, name)."""
    busy = stats.union_length([(s, e) for s, e, _ in intervals]) / 1e9
    by_name: dict[str, float] = {}
    for s, e, n in intervals:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    kernel_s = {k: sum(v for n, v in by_name.items() if sub in n)
                for k, sub in kernel_names.items()}
    ops = sorted(([n[:160], v] for n, v in by_name.items()), key=lambda x: -x[1])[:10]
    return busy, kernel_s, ops


class Trace:
    """What the profiler saw in the window: ``busy_s``, ``window_s``,
    each kernel's device seconds, the top device operations and the
    longest idle gaps by what the host was doing."""

    def __init__(self, kernel_names: dict[str, str]):
        self.kernel_names = kernel_names  # kernel -> substring of its device name
        self.busy_s = self.window_s = None
        self.kernel_s: dict[str, float] = {}
        self.device_ops: list = []
        self.idle_gaps: list = []
        self.read_s = None  # (seconds to stop the profiler, seconds to read its events)

    def __enter__(self):
        _start_profiler()
        return self

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        events = _stop_profiler()
        t1 = time.perf_counter()
        if exc[0] is None:
            self._read(events)
        self.read_s = (t1 - t0, time.perf_counter() - t1)
        return False

    def _read(self, events) -> None:
        gpu, cpu, cpu_events, longest = [], [], [], None
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                if not _annotation(e):
                    gpu.append((s, s + d, e.name()))
            else:
                # the window is the longest host range; names are read lazily
                if longest is None or d > cpu[longest][1] - cpu[longest][0]:
                    longest = len(cpu)
                cpu.append((s, s + d))
                cpu_events.append(e)
        if longest is None or cpu_events[longest].name() != WINDOW:
            raise RuntimeError(f"the profiler recorded no {WINDOW!r} range")
        t0, t1 = cpu[longest]
        self.window_s = (t1 - t0) / 1e9
        inside = [(max(s, t0), min(e, t1), n) for s, e, n in gpu if e > t0 and s < t1]
        self.busy_s, self.kernel_s, self.device_ops = _device_work(inside, self.kernel_names)
        gaps = sorted(stats.gaps([(s, e) for s, e, _ in inside], t0, t1),
                      key=lambda g: g[0] - g[1])[:10]
        cs = np.array([c[0] for c in cpu], dtype=np.float64)
        ce = np.array([c[1] for c in cpu], dtype=np.float64)
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            hit = np.flatnonzero((cs <= mid) & (ce >= mid))
            # the innermost host range open over the gap's middle
            name = cpu_events[hit[np.argmax(cs[hit])]].name() if hit.size else "no host range"
            self.idle_gaps.append([name[:160], (g1 - g0) / 1e9])


class DeviceSection:
    """The device's work in one stretch of the run outside the window
    (set-up's build of the fixed graph), under a session of its own that
    records the CUDA activities alone, so that the host's time over the
    stretch, which the run also reads, stays near what it is untraced:
    ``busy_s`` (merged device intervals), ``window_s`` (the stretch on the
    host clock), each kernel's device seconds and the top device
    operations.  Every device interval of the session is the stretch's."""

    def __init__(self, kernel_names: dict[str, str]):
        self.kernel_names = kernel_names
        self.busy_s = self.window_s = None
        self.kernel_s: dict[str, float] = {}
        self.device_ops: list = []

    def __enter__(self):
        _start_profiler(host=False)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        events = _stop_profiler()
        if exc[0] is None:
            gpu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                   if str(e.device_type()).endswith("CUDA") and not _annotation(e)]
            self.busy_s, self.kernel_s, self.device_ops = _device_work(gpu, self.kernel_names)
        return False
