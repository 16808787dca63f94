"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` and of the
role of ``idto_tpu/utils/cache.py``.

The JAX package compiles each entry point of its main path once into one
XLA program and replays it on every later call; its MPC step is one
program with a device-resident carry, no host round trip inside it.  The
port's main path is thousands of small PyTorch ops a call, each a kernel
launch from the host.  :func:`run` captures such a region of ops once per
key into a CUDA graph and replays it afterwards: the same kernels, in the
same order, on the same numbers; one graph launch replaces their launches.

**The key** is the region's name, the identity of the model object, the
caller's static values (the ``SolverParameters``, step counts, masks, and
for a horizon-sharded solve its split: the process group, this rank's
place in it, the world size and the rank's knot range) and the structure
of the arguments: for each tensor its shape, strides, alignment, dtype and
device, for every other leaf its type and value.  A new model object, a
new shape, a changed parameter or another split captures anew: a sharded
and an unsharded solve of the same shapes never share a graph.

**Inputs** are copied into static buffers of the same layout on every
call (an expanded tensor stays expanded), so the replay sees exactly the
strides the eager ops would.  A tensor that a region produced (a static
output, or a static input passed through) is taken as the next region's
static input as it is: a chain of regions runs without copies.
**Outputs** are cloned before they are returned (``clone=False`` hands out
the static outputs themselves: only for a caller that passes them to the
next region before any other region replays).

**The first call of a key** runs the region eagerly on a side stream (the
warm-up: it fills the constant caches of ``utils/consts.py``, which raise
on a miss during a capture, builds the CUDA kernel, creates the cuBLAS
handles), empties the allocator's cache, captures the region with
synchronizing calls made errors, and replays it:
the capture's cost lands in the first call, as the JAX compile does.  A
failed capture or replay raises with the region's name; nothing carries on
eagerly.  Each graph keeps a memory pool of its own: the loop replays its
regions in another order than it captured them (prepare, advance,
prepare, ...), and in a pool shared between two graphs the scratch of the
one captured first may sit where the other keeps its outputs, which a
replay of the first would then overwrite before they are read.

**Kernel counts** (``register_counter``): a capture records how many
launches of each counted kernel it holds; each replay adds that number.
The warm-up's launches go to :data:`warmup_launches`, not to the kernel's
count, and the capture's own calls of the wrapper launch nothing.

**Spans** (``utils/profiler.py``): each region is the outermost span of
its callable.  A capture gives it fresh site ids, its warm-up stamps them
as ordinary launches, and the capture places a stamp at the first and the
last node of the graph, so that every replay stamps the region and the
named spans inside it on the device.  A direct run stamps under the
region's one direct scope.  The host spans ``graphs.copy_in <region>``
and ``graphs.launch <region>`` go around a replay's copies and launch.

**Collectives** (``group``): a region that makes collectives over a
process group is captured with them when the group runs NCCL.  Its
communicator comes into being in the warm-up, on the side stream, before
the capture.  Every rank of the group must capture and replay the same
regions in the same order, or one rank's collectives would wait for
others that never come: before each capture or replay on a group of more
than one rank, the ranks exchange through the default group's store
which region they run and how (a host exchange, no device read), and a
rank that finds another region, or none within :data:`AGREE_SECONDS`,
raises with the region's name.  A gloo group cannot be captured: on CUDA
tensors its regions run directly, and :data:`direct_runs` counts them by
name.  A group cannot be destroyed while a graph that holds its
collectives lives (NCCL waits for the graph, and
``destroy_process_group`` hangs on four cards): call :func:`reset` first.

Tensors on the CPU run the region directly (the tests and ``--device
cpu``), and so does everything inside :func:`eager` (for holding the
captured route against the eager one).  :func:`stand_in` is for the tests
alone: on CPU tensors it takes the captured route's bookkeeping (keys,
static buffers, copies, clones, counts) and re-runs the recorded callable
on the same static buffers in place of a graph replay.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time
import weakref
from typing import Any, Callable

import torch

from idto_tpu_torch.utils import profiler

_DIRECT, _STAND_IN = "direct", "stand_in"
_mode = None  # None: capture CUDA tensors; or _DIRECT / _STAND_IN

_entries: dict = {}
_owned: dict = {}  # id(tensor) -> weakref of the static buffers of every entry
_streams: dict = {}  # device -> the side stream of warm-ups and captures
_counters: list = []  # (module, attribute) of each counted kernel
_agreed: dict = {}  # group name -> regions run on the group's captured route

# Seconds and launches spent on first calls since import (or since reset).
capture_seconds: dict = {}  # region name -> seconds of warm-ups + captures
warmup_launches = 0
captures = 0
replays = 0
# Region name -> runs on CUDA tensors left direct: their group is gloo.
direct_runs: dict = {}

# Seconds a rank waits for the others to reach a region of their group.
AGREE_SECONDS = 300

_ALIGN = 512  # bytes: the caching allocator's block alignment


def register_counter(module, attr: str) -> None:
    """Count a kernel's launches through replays: ``module.attr`` is an int
    that the kernel's wrapper increments at each launch."""
    if (module, attr) not in _counters:
        _counters.append((module, attr))


@contextlib.contextmanager
def eager():
    """Run every region directly, as eager PyTorch ops, inside this block:
    the route that the captured one is held against (tests and
    ``chip_smoke.py``; the main path never enters it)."""
    global _mode
    prev, _mode = _mode, _DIRECT
    try:
        yield
    finally:
        _mode = prev


@contextlib.contextmanager
def stand_in():
    """Tests only: regions on CPU tensors take the captured route's
    bookkeeping, with a re-run of the recorded callable on the static
    buffers in place of a graph replay.  Never used for a CUDA tensor."""
    global _mode
    prev, _mode = _mode, _STAND_IN
    try:
        yield
    finally:
        _mode = prev


def reset() -> None:
    """Drop every captured graph and its buffers (their memory goes back to
    the allocator once nothing holds their outputs).  Call it before
    destroying a process group whose collectives a graph holds."""
    global warmup_launches, captures, replays
    _entries.clear()
    _owned.clear()
    capture_seconds.clear()
    direct_runs.clear()
    warmup_launches = captures = replays = 0


# -- argument structures -------------------------------------------------------

_TENSOR = object()


def _flatten(x, leaves: list):
    """A hashable description of ``x`` with its tensors appended to
    ``leaves``: tuples, lists, dicts, NamedTuples and dataclasses are
    walked; any other leaf must be hashable and is part of the key."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return (dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names,
                tuple(_flatten(getattr(x, n), leaves) for n in names))
    hash(x)
    return ("static", type(x), x)


def _unflatten(spec, leaves):
    """Rebuild the structure of ``spec`` from an iterator of tensors."""
    if spec is _TENSOR:
        return next(leaves)
    kind = spec[0]
    if kind == "static":
        return spec[2]
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if dataclasses.is_dataclass(kind):
        return kind(**{n: _unflatten(s, leaves)
                       for n, s in zip(spec[1], spec[2])})
    items = [_unflatten(s, leaves) for s in spec[1]]
    if hasattr(kind, "_fields"):  # NamedTuple
        return kind(*items)
    return kind(items)


def _meta(t: torch.Tensor):
    """What a replay depends on of a tensor besides its values."""
    return (tuple(t.shape), t.stride(), t.dtype, t.device,
            t.storage_offset() * t.element_size() % _ALIGN)


def _compact(t: torch.Tensor):
    """``t`` with each expanded (stride 0) dimension cut to length 1."""
    return t.as_strided(
        [1 if st == 0 else n for n, st in zip(t.shape, t.stride())],
        t.stride())


def _buffer(t: torch.Tensor):
    """A new tensor of t's shape, strides (expanded dimensions included)
    and alignment."""
    c = _compact(t)
    span = 1 + sum((n - 1) * st for n, st in zip(c.shape, c.stride())) \
        if c.numel() else 0
    off = t.storage_offset() % (_ALIGN // t.element_size())
    base = torch.empty(off + span, dtype=t.dtype, device=t.device)
    return base.as_strided(t.shape, t.stride(), off)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src for two tensors of one layout, expanded or not."""
    _compact(dst).copy_(_compact(src))


def _is_owned(t: torch.Tensor) -> bool:
    ref = _owned.get(id(t))
    return ref is not None and ref() is t


def _own(t: torch.Tensor) -> None:
    _owned[id(t)] = weakref.ref(t)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


# -- collectives ---------------------------------------------------------------


def _agree(group, name: str, how: str) -> None:
    """Raise unless every rank of ``group`` runs ``name`` the same way
    (``how``: a capture or a replay) as its next region on the group.  Each
    rank posts its region to the default group's store under the count of
    regions run on this group so far, and reads the others' posts; then it
    deletes its post of the region before, which every rank has read by
    then (none posts a region before it has read all posts of the last)."""
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    if len(ranks) < 2:
        return
    store = dist.distributed_c10d._get_default_store()
    gid = group.group_name
    n = _agreed.get(gid, 0)
    _agreed[gid] = n + 1
    prefix = f"idto_graphs/{gid}/{n}/"
    mine = f"{name} ({how})"
    me = dist.get_rank()
    store.set(prefix + str(me), mine)
    try:
        store.wait([prefix + str(r) for r in ranks],
                   datetime.timedelta(seconds=AGREE_SECONDS))
    except RuntimeError as e:  # the store's timeout
        raise RuntimeError(
            f"region {name!r}: rank {me} ran it as its region {n} on the "
            f"group of ranks {ranks}, and not every rank reached a region "
            f"{n} within {AGREE_SECONDS} s") from e
    theirs = {r: store.get(prefix + str(r)).decode() for r in ranks}
    if n:
        store.delete_key(f"idto_graphs/{gid}/{n - 1}/{me}")
    if any(v != mine for v in theirs.values()):
        raise RuntimeError(
            f"region {name!r}: the ranks of one group run other regions as "
            f"their region {n}: {theirs}")


# -- the route -----------------------------------------------------------------


@dataclasses.dataclass
class _Entry:
    name: str
    inputs: list  # static input buffers, one a tensor leaf
    out_spec: Any = None
    outputs: list = None  # static output tensors
    graph: Any = None  # torch.cuda.CUDAGraph, or the callable (stand-in)
    launches: tuple = ()  # per counter, launches a replay makes
    keep: tuple = ()  # objects the key names by identity
    scope: Any = None  # the sites of its spans (utils/profiler.py)
    copy_in: str = ""  # the host spans around a replay
    launch: str = ""


def _counts():
    return [getattr(m, a) for m, a in _counters]


def _set_counts(values):
    for (m, a), v in zip(_counters, values):
        setattr(m, a, v)


def run(name: str, fn: Callable, args: tuple, *, model=None, key=(),
        clone: bool = True, group=None):
    """``fn(*args)`` as a captured region: on CUDA tensors, a replay of its
    graph (captured at the first call of this key); on CPU tensors, or
    inside :func:`eager`, a direct call.

    ``fn`` may read ``model`` (named in the key by identity) and the
    hashable values in ``key``, and nothing else but ``args``: tensors it
    reads from elsewhere would be read at their capture-time addresses.
    It must not write its arguments in place.  ``group`` is the process
    group of the collectives ``fn`` makes (None: it makes none); on CUDA
    tensors a gloo group's region runs directly."""
    leaves: list = []
    spec = _flatten(args, leaves)
    device = leaves[0].device if leaves else None
    if device is None:
        return fn(*args)
    if _mode == _DIRECT or (device.type == "cpu" and _mode != _STAND_IN):
        return _direct(name, fn, args, device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"region {name!r}: no graphs on {device}")
    if group is not None and device.type == "cuda":
        import torch.distributed as dist

        if dist.get_backend(group) != "nccl":  # no graph holds gloo's
            direct_runs[name] = direct_runs.get(name, 0) + 1
            return _direct(name, fn, args, device)
    full_key = (name, id(model), key, spec, tuple(_meta(t) for t in leaves))
    entry = _entries.get(full_key)
    if group is not None:
        _agree(group, name, "replay" if entry else "capture")
    if entry is None:
        entry = _capture(name, fn, spec, leaves, device, model)
        _entries[full_key] = entry
    return _replay(entry, leaves, clone)


def _direct(name, fn, args, device):
    """``fn(*args)`` run directly, its spans stamped as the region's."""
    with profiler.region(profiler.direct_scope(name, device)):
        return fn(*args)


def _capture(name, fn, spec, leaves, device, model) -> _Entry:
    """The first call of a key: static input buffers, the warm-up, the
    capture (or, under the stand-in, the recorded callable)."""
    global warmup_launches, captures
    t0 = time.perf_counter()
    inputs = []
    for t in leaves:
        # Another region's buffer is read where it is, once: a tensor that
        # fills two slots gets a buffer of its own in the second, which a
        # later call may fill with another value.
        if _is_owned(t) and not any(t is b for b in inputs):
            inputs.append(t)
        else:
            inputs.append(_buffer(t))
            _copy(inputs[-1], t)
    # The region's spans: fresh sites, stamped in the warm-up, captured as
    # the graph's first and last nodes (each replay stamps again).
    scope = profiler.Scope(name, device)
    entry = _Entry(name=name, inputs=inputs, keep=(model,), scope=scope,
                   copy_in=f"graphs.copy_in {name}",
                   launch=f"graphs.launch {name}")

    def call():
        with profiler.region(scope):
            return fn(*_unflatten(spec, iter(inputs)))

    before = _counts()
    if device.type == "cuda":
        profiler.prepare(device)
        stream = _streams.setdefault(device, torch.cuda.Stream(device))
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            warm = call()  # the warm-up
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        warmed = _counts()
        graph = torch.cuda.CUDAGraph()
        sync_mode = torch.cuda.get_sync_debug_mode()
        try:
            torch.cuda.set_sync_debug_mode("error")
            # Other threads (NCCL's watchdog, the profiler) may call CUDA
            # meanwhile: only this thread's calls are held to the capture.
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = call()
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the region {name!r} failed: {e}"
            ) from e
        finally:
            torch.cuda.set_sync_debug_mode(sync_mode)
        entry.graph = graph
    else:  # the stand-in: a warm-up run, then the recorded callable
        warm = call()
        warmed = _counts()
        out = call()
        entry.graph = call
    after = _counts()
    warmup_launches += sum(w - b for w, b in zip(warmed, before))
    entry.launches = tuple(a - w for a, w in zip(after, warmed))
    _set_counts(before)
    outputs: list = []
    entry.out_spec = _flatten(out, outputs)
    entry.outputs = outputs
    # An output at the address of one of the warm-up's (both still held) was
    # made before the region ran -- a model tensor or a constant: it is not
    # a buffer of the graphs, and no region may copy into it.
    held: list = []
    _flatten(warm, held)
    elsewhere = {_ptr(t) for t in held} - {_ptr(t) for t in inputs}
    for t in inputs + [t for t in outputs if _ptr(t) not in elsewhere]:
        _own(t)
    captures += 1
    capture_seconds[name] = (capture_seconds.get(name, 0.0)
                             + time.perf_counter() - t0)
    return entry


def _replay(entry: _Entry, leaves, clone: bool):
    global replays
    # A leaf that is another slot's buffer is read before any copy lands.
    dests = {id(b) for b in entry.inputs}
    with profiler.instrument(entry.copy_in):
        leaves = [t.clone() if id(t) in dests and t is not b else t
                  for t, b in zip(leaves, entry.inputs)]
        for t, buf in zip(leaves, entry.inputs):
            if t is not buf:
                _copy(buf, t)
    counts = _counts()
    with profiler.instrument(entry.launch):
        if isinstance(entry.graph, torch.cuda.CUDAGraph):
            try:
                entry.graph.replay()
            except Exception as e:
                raise RuntimeError(
                    f"CUDA graph replay of the region {entry.name!r} "
                    f"failed: {e}") from e
        else:
            out = entry.graph()
            fresh: list = []
            _flatten(out, fresh)
            for dst, src in zip(entry.outputs, fresh):
                if dst is not src:
                    _copy(dst, src)
    _set_counts([c + n for c, n in zip(counts, entry.launches)])
    replays += 1
    outs = [t.clone() if clone else t for t in entry.outputs]
    return _unflatten(entry.out_spec, iter(outs))
