"""The port's spans: one context manager, :func:`instrument`, with up to
three outputs (the port's counterpart of ``idto_tpu/utils/profiler.py`` and
of the reference's ``INSTRUMENT_FUNCTION`` / ``TableOfAverages``,
utils/profiler.h:165-235).

**Device stamps.** A span that runs inside a region's callable
(``utils/graphs.py::run``, which makes the region itself the outermost
span) stamps its entry and its exit into a ring of records on the region's
device.  On a CUDA device the stamp is a one-thread kernel
(``csrc/span_stamp.cu``) enqueued on the current stream: it writes the
span's code (site id << 1, plus 1 at the exit) and the device's
``%globaltimer`` in nanoseconds at a slot it takes with ``atomicAdd``.
Inside a CUDA graph capture the launch becomes a node of the graph, so
every replay stamps again; in a region's eager warm-up, under
``graphs.eager()`` or on a gloo group the stamp is an ordinary launch.  On
the CPU (and under ``graphs.stand_in()``) the records carry
``time.perf_counter_ns()`` instead.  A span outside every region (the host
spans: ``mpc.step``, ``batch.solve``, ``graphs.copy_in``,
``graphs.launch``, the host reads) stamps nothing.

**Sites.** Each capture of a region allocates fresh site ids, so the same
line of code in two graphs has two ids.  :data:`sites` maps an id to the
span's name, its parent (the enclosing span or region) and the kernel,
memcpy and memset nodes the capture placed between its two stamps,
counted from the capturing stream's graph at the span's entry and exit
(the card runs most memcpy nodes as kernels; together they are the device
operations a profiler records for a replay): that costs nothing at a
replay.

**Host side.** While a ``torch.profiler`` is recording, every span opens
``record_function("idto." + name)``, so that the program's spans sit in
the trace on the device trace's clock; after ``set_enabled(True)``
(``examples/run.py --profile``) every span also feeds the host-clock table
of :func:`table_of_averages`.  Both are off by default: a host span then
costs one boolean test, and a replay adds only the stamp nodes it
captured.

The ring holds the newest :data:`RING_RECORDS` records of each device;
:func:`device_records` copies them to the host in order and
:func:`intervals` pairs them into spans.

Usage:
    with instrument("solve"):
        ...
    print(table_of_averages())
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

# Records a device's ring holds: a power of two.  A 20 s window of replans
# writes ~24,000 (the hopper's: 34 stamps a replan of 28 ms).
RING_RECORDS = 1 << 18

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "span_stamp.cu")


@dataclasses.dataclass
class Site:
    name: str
    parent: int  # the enclosing span's or region's site id; -1: a region
    # Kernel, memcpy and memset nodes between its stamps (a capture's): the
    # card runs most memcpy nodes of a graph as kernels.
    kernels: int | None = None


sites: list = []  # site id -> Site


@dataclasses.dataclass
class _Timer:
    samples: int = 0
    total: float = 0.0
    child_time: float = 0.0

    @property
    def self_total(self) -> float:
        return self.total - self.child_time


_timers: dict[str, _Timer] = {}
_stack: list = []  # (name, host-clock start) of the open timed spans
_enabled = False
_frames: list = []  # the open spans of the region that runs
_rings: dict = {}  # device -> _Ring
_scopes: dict = {}  # (region, device) -> the Scope of its direct runs
_lib = None
_OFF = contextlib.nullcontext()


def set_enabled(flag: bool) -> None:
    """Keep the host-clock table (off by default)."""
    global _enabled
    _enabled = flag


def reset() -> None:
    """Drop the host-clock table and every ring's records.  The rings and
    the sites stay for the life of the process: captured graphs stamp
    their ids into the rings' memory, so a ring is emptied in place."""
    _timers.clear()
    _stack.clear()
    for ring in _rings.values():
        ring.clear()


def _load():
    global _lib
    if _lib is None:
        from idto_tpu_torch.ops import cr_kernel

        lib = ctypes.CDLL(cr_kernel.build(_SOURCE))
        lib.span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_ulonglong, ctypes.c_longlong,
                                   ctypes.c_void_p]
        lib.span_stamp.restype = ctypes.c_int
        lib.span_capture_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.span_capture_nodes.restype = ctypes.c_int
        _lib = lib
    return _lib


class _Ring:
    """The records of one device: (code, ns) rows and a running count."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capacity = RING_RECORDS
        if device.type == "cuda":
            _load()
            self.data = torch.zeros((self.capacity, 2), dtype=torch.int64,
                                    device=device)
            self.count = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.data = np.zeros((self.capacity, 2), dtype=np.int64)
            self.count = 0

    def clear(self) -> None:
        if self.device.type == "cuda":
            self.count.zero_()
        else:
            self.count = 0

    def stamp(self, code: int) -> None:
        if self.device.type != "cuda":
            slot = self.count & (self.capacity - 1)
            self.data[slot] = (code, time.perf_counter_ns())
            self.count += 1
            return
        with torch.cuda.device(self.device):
            err = _lib.span_stamp(
                self.data.data_ptr(), self.count.data_ptr(),
                self.capacity - 1, code,
                torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"span stamp launch failed: CUDA error {err}")

    def nodes(self):
        """Kernel, memcpy and memset nodes of the graph the current stream
        captures into, or None when it captures nothing."""
        if self.device.type != "cuda" or \
                not torch.cuda.is_current_stream_capturing():
            return None
        counts = (ctypes.c_longlong * 3)()
        err = _lib.span_capture_nodes(
            torch.cuda.current_stream(self.device).cuda_stream, counts)
        if err != 0:
            raise RuntimeError(f"counting a capture's nodes failed ({err})")
        return sum(counts)

    def read(self):
        """(count of records ever written, the newest min(count, capacity)
        records in order, oldest first)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            count = int(self.count.item())
            data = self.data.cpu().numpy()
        else:
            count, data = self.count, self.data
        held = np.arange(max(0, count - self.capacity), count)
        return count, data[held & (self.capacity - 1)].copy()


def _device(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _ring(device: torch.device) -> _Ring:
    ring = _rings.get(device)
    if ring is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the span ring of a device must exist before "
                               "a capture on it (graphs.run makes it in the "
                               "warm-up)")
        ring = _rings[device] = _Ring(device)
    return ring


def prepare(device) -> None:
    """Make ``device``'s ring (and on a card build the stamp kernel):
    before a capture, which may not allocate it."""
    _ring(_device(device))


class Scope:
    """The sites of one capture of a region, or of the region's direct
    runs: a span is known by its parent, its name and how many spans of
    that name its parent opened before it in the run."""

    def __init__(self, region: str, device):
        self.region = region
        self.device = _device(device)
        self._ids: dict = {}

    def site(self, parent: int, name: str, ordinal: int) -> int:
        key = (parent, name, ordinal)
        sid = self._ids.get(key)
        if sid is None:
            sid = self._ids[key] = len(sites)
            sites.append(Site(name, parent))
        return sid


def direct_scope(region: str, device) -> Scope:
    """The one Scope of a region's direct runs on ``device``."""
    key = (region, _device(device))
    scope = _scopes.get(key)
    if scope is None:
        scope = _scopes[key] = Scope(region, device)
    return scope


class _Frame:
    """An open span of the running region: its site, the spans it opened
    by name (``seen``) and the capture's node count at its entry."""

    __slots__ = ("site", "scope", "ring", "seen", "nodes")

    def __init__(self, site, scope, ring):
        self.site, self.scope, self.ring = site, scope, ring
        self.seen: dict = {}
        self.nodes = None


class _HostSpan:
    """The host side of a span: a ``record_function`` range while a
    profiler records, the host-clock table when it is enabled."""

    __slots__ = ("name", "_range", "_timed")

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._timed = False

    def __enter__(self):
        if _torch_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function("idto." + self.name)
            self._range.__enter__()
        if _enabled:
            self._timed = True
            _stack.append((self.name, time.perf_counter()))
        return self

    def __exit__(self, *exc):
        if self._timed:
            name, start = _stack.pop()
            elapsed = time.perf_counter() - start
            t = _timers.setdefault(name, _Timer())
            t.samples += 1
            t.total += elapsed
            if _stack:
                _timers.setdefault(_stack[-1][0], _Timer()).child_time += \
                    elapsed
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _Span(_HostSpan):
    """A span inside a region: the host side and two device stamps."""

    __slots__ = ("frame",)

    def __init__(self, name: str, frame: _Frame):
        super().__init__(name)
        self.frame = frame

    def __enter__(self):
        super().__enter__()
        f = self.frame
        f.ring.stamp(f.site << 1)
        f.nodes = f.ring.nodes()
        _frames.append(f)
        return self

    def __exit__(self, *exc):
        f = self.frame
        _frames.pop()
        if exc[0] is None:
            if f.nodes is not None:
                sites[f.site].kernels = f.ring.nodes() - f.nodes
            f.ring.stamp(f.site << 1 | 1)
        return super().__exit__(*exc)


def _child(name: str) -> _Frame:
    top = _frames[-1]
    ordinal = top.seen.get(name, 0)
    top.seen[name] = ordinal + 1
    return _Frame(top.scope.site(top.site, name, ordinal), top.scope,
                  top.ring)


def instrument(name: str):
    """A span named ``name`` (a context manager): device stamps inside a
    region, the host side while a profiler records or the table is
    enabled, nothing otherwise."""
    if _frames:
        return _Span(name, _child(name))
    if _enabled or _torch_profiler._is_profiler_enabled:
        return _HostSpan(name)
    return _OFF


@contextlib.contextmanager
def region(scope: Scope):
    """The outermost span of a region's callable: its stamps are the first
    and the last node of the region's graph.  Inside another region (a
    direct run) it is a span of that region."""
    if _frames:
        with instrument(scope.region):
            yield
        return
    frame = _Frame(scope.site(-1, scope.region, 0), scope,
                   _ring(scope.device))
    depth = len(_frames)
    try:
        with _Span(scope.region, frame):
            yield
    finally:
        del _frames[depth:]


# -- reading the records ------------------------------------------------------


def device_records(device=None):
    """(records ever written, the ring's records (n, 2) int64 in order) of
    ``device`` -- by default the CUDA device that has a ring, else the
    CPU's -- or None where no span has run there."""
    if device is None:
        cuda = [d for d in _rings if d.type == "cuda"]
        device = cuda[0] if cuda else "cpu"
    ring = _rings.get(_device(device))
    return None if ring is None else ring.read()


def intervals(records):
    """The spans of a run of records (oldest first): a list of (site id,
    position of its entry, entry ns, exit ns, self ns), in the order of
    their entries, where self is the span's time not under a child span.
    An entry without its exit (a failed capture, or records cut at the
    ring's end) is left out."""
    out, open_ = [], []  # open_: [site, position, ns, children's ns]
    for pos, (code, ns) in enumerate(records.tolist()):
        site, leaving = code >> 1, code & 1
        if not leaving:
            open_.append([site, pos, ns, 0])
            continue
        while open_ and open_[-1][0] != site:
            open_.pop()
        if not open_:
            continue
        site, start, t0, inner = open_.pop()
        out.append((site, start, t0, ns, ns - t0 - inner))
        if open_:
            open_[-1][3] += ns - t0
    out.sort(key=lambda iv: iv[1])
    return out


def device_table(device=None) -> dict:
    """{span name: (samples, device ms in all)} over the ring of
    ``device`` (see :func:`device_records`)."""
    got = device_records(device)
    table: dict = {}
    if got is None:
        return table
    for site, _, t0, t1, _ in intervals(got[1]):
        n, ms = table.get(sites[site].name, (0, 0.0))
        table[sites[site].name] = (n + 1, ms + 1e-6 * (t1 - t0))
    return table


def table_of_averages(device=None) -> str:
    """The host-clock table (time/sample, samples, total, self-time share;
    reference: TableOfAverages, utils/profiler.cc) beside each span's
    device time a sample from the ring of ``device``.  A captured span's
    host time is its capture's; its device time is every replay's."""
    dev = device_table(device)
    names = sorted(set(_timers) | set(dev), key=lambda k: -max(
        _timers[k].total if k in _timers else 0.0,
        1e-3 * dev.get(k, (0, 0.0))[1]))
    if not names:
        return "(no instrumented scopes)"
    lines = [
        f"{'scope':<40} {'ms/sample':>12} {'samples':>8} "
        f"{'total s':>10} {'self %':>8} {'device ms':>10} {'stamped':>8}"
    ]
    for name in names:
        t = _timers.get(name, _Timer())
        per = 1e3 * t.total / max(t.samples, 1)
        selfpct = 100.0 * t.self_total / max(t.total, 1e-12)
        n, ms = dev.get(name, (0, 0.0))
        lines.append(
            f"{name:<40} {per:>12.3f} {t.samples:>8} "
            f"{t.total:>10.3f} {selfpct:>8.1f} "
            f"{(ms / n if n else float('nan')):>10.3f} {n:>8}"
        )
    return "\n".join(lines)
