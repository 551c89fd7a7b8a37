"""The program's one recorder of spans and counters.

    from upside_md_torch import tracing
    tracing.enable()
    ...                                  # run the program
    tracing.disable()
    w = tracing.last_window()
    w.spans["node.rotamer"].stream_s     # device time between its events
    tracing.write_chrome("spans.json")   # the window as a Chrome trace

**Counters** count always: `count(name, n)` adds to a host integer and
never touches the device.  `kernel.<k>` counts in `LAUNCHES[k]` (each
call of `ops/kernels.launch`), `sync.<site>` in `HOST_SYNCS[site]` (each
host read of device data, `sync`), `nlist.<site>` in `LISTS_BUILT[site]`
(each fixed-K neighbour list built, `neighbour_list_span`).

**Spans** record only while the recorder is on: after `enable()`, and
while a `torch.profiler` collects (`torch._C._autograd._profiler_enabled`).
Off, `span()` costs one flag check and returns a shared object that does
nothing.  On, a span records its name, its parent (the innermost span
open on its thread; on a thread with none of its own, such as the
autograd engine's, the innermost open span of the thread that opened the
window), an id (the force-evaluation counter in MD, the step in
training), its host start and end on `time.time_ns()` (the clock
`torch.profiler` stamps its events with: `trace_start_ns()`), and a pair
of timing CUDA events on the current stream.  Inside a profiler it also
opens a `record_function` range of its name, so that a profile that
records host activity shows the span over the kernels it launched.  The events are
never waited on while the window is open: they are resolved when the
window is read, and in between, past MAX_PENDING spans, as `query()` finds
them done.

**Windows**.  A window opens when the recorder turns on: at `enable()`,
or at the first span inside a profiler.  It closes at `disable()`; a
window a profiler opened closes at the first span after the profiler has
stopped; any window closes when `last_window()` is read (spans still on
then open a new one).  A span opened in a window is recorded in it to its
end.

**Backward spans**.  `backward_span(name, id)` returns None when off;
on, a function that passes a forward call's output through an identity
autograd function (a view: no kernel) whose backward opens the span when
the output's cotangent arrives.  Autograd runs a node's backward ops
together, in the reverse order of their forward, so the span ends when
the next backward span opens on its thread, or when the backward pass
ends.  (Markers on the inputs as well, to end it there, would make
autograd sum an input's cotangents in another grouping, and so change
forces in the last bit.)  So a backward span opened inside a node's
backward, such as a neighbour list's, ends that node's backward span
there: the node's backward reads as two spans in turn, not nested.

**Neighbour lists**.  `neighbour_list_span(site, compute, *args)` runs one
fixed-K neighbour list's whole forward (`ops/pairs.py`: the list's build,
the row gather, the spline on the list, the scatter back) in the span
`nlist.<site>`, with the build in a nested `nlist.build`, its output
through the backward marker `nlist.<site>.bwd`, and counts it in
`nlist.<site>`.  The sites: `rotamer` (the bead grid past 1,024 beads),
the coverage node's name (`hbond_coverage`, `hbond_coverage_hydrophobe`,
past 1,024 columns) and `radial` (past 1,024 probes).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import torch

LAUNCHES = {}      # hand-written kernel calls by kernel (`kernel.<k>`)
HOST_SYNCS = {}    # host reads of device data by site (`sync.<site>`)
LISTS_BUILT = {}   # fixed-K neighbour lists built by site (`nlist.<site>`)
_GROUPS = {"kernel": LAUNCHES, "sync": HOST_SYNCS, "nlist": LISTS_BUILT}

# spans whose raw records a window keeps for `write_chrome`; past it the
# window keeps its sums alone
MAX_RECORDS = 200_000
# closed spans a window holds unresolved; past it, it resolves those whose
# events the device has passed (so that a window left open stays bounded)
MAX_PENDING = 4096

_profiling = torch._C._autograd._profiler_enabled
# a span's range in a profile: `record_function`, in its fast C++ form
# where torch has one (under a profiler, 1-2 us a span against 8-14)
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.autograd.profiler.record_function
_forced = False
_window = None     # the open window
_last = None       # the last closed window
_lock = threading.RLock()
_local = threading.local()
_queued = False    # an end-of-backward callback is queued


def count(name, n=1):
    """Add n to the counter `name`, `kernel.<k>`, `sync.<site>` or
    `nlist.<site>`."""
    group, _, key = name.partition(".")
    d = _GROUPS[group]
    d[key] = d.get(key, 0) + n


def counters():
    """Every counter, flat: {"kernel.<k>": n, "sync.<site>": n,
    "nlist.<site>": n}."""
    return {f"{g}.{k}": v for g, d in _GROUPS.items() for k, v in d.items()}


def on():
    """Whether spans record now."""
    return _forced or _profiling()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def span(name, id=None):
    """A context manager: the span `name` around its block while the
    recorder is on, NOOP otherwise."""
    if _forced or _profiling():
        return _Span(name, id)
    if _window is not None:
        _end_window()
    return NOOP


def sync(site):
    """A host read of device data at `site`: counted in HOST_SYNCS[site]
    always, and spanned `sync.<site>` while on.  Use as
    `with tracing.sync("site"): value = float(t)`."""
    name = "sync." + site
    count(name)
    return span(name)


def neighbour_list_span(site, compute, *args):
    """compute(*args), one neighbour list's whole forward, counted in
    `nlist.<site>` and, while on, in the span `nlist.<site>`; its output,
    a tensor or a tuple whose first entry is the list's values, passes
    that tensor through the backward marker `nlist.<site>.bwd`."""
    name = "nlist." + site
    count(name)
    bwd = backward_span(name + ".bwd")
    with span(name):
        out = compute(*args)
        if bwd is not None:
            out = (bwd(out[0]),) + out[1:] if isinstance(out, tuple) \
                else bwd(out)
    return out


def enable():
    """Turn spans on and open a window (closing any open one)."""
    global _forced
    with _lock:
        _end_window()
        _forced = True
        _open_window()


def disable():
    """Turn spans off (a running profiler still turns them on) and close
    the window."""
    global _forced
    with _lock:
        _forced = False
        _end_window()


def last_window():
    """The last closed window's `Window` (closing the open one first), or
    None if no window has been open."""
    with _lock:
        _end_window()
        w = _last
    return None if w is None else w.finish()


def write_chrome(path, window=None):
    """Write the last window's spans (or `window`'s) as Chrome-trace JSON,
    timestamps in microseconds since the epoch, so that the file overlays
    a `torch.profiler` export; each span's args hold its id and stream
    milliseconds.  Returns the path."""
    w = window or last_window()
    events = []
    for r in w.records if w is not None else ():
        args = {"id": r.id, "parent": r.parent}
        if r.stream_s is not None:
            args["stream_ms"] = 1e3 * r.stream_s
        events.append({"name": r.name, "ph": "X", "pid": os.getpid(),
                       "tid": r.thread, "ts": r.t0_ns / 1e3,
                       "dur": (r.t1_ns - r.t0_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def is_user_annotation(event):
    """Whether a `torch.profiler` event is a span's annotation rather than
    work: the `record_function` ranges and their device-side copies,
    which a profile that records host activity lists among the device's
    events.  Counts and device times of kernels leave them out."""
    return bool(getattr(event, "is_user_annotation", False)) or \
        event.name.split(".")[0] in _KINDS


# the first part of every span name the program opens
_KINDS = frozenset(("md", "node", "fused_pair", "bp", "kernel", "kernels",
                    "sync", "train", "cotangent", "io", "nlist"))


# ---------------------------------------------------------------------------
# what a window gives
# ---------------------------------------------------------------------------

@dataclass
class Stats:
    """One span name's (or one pair of names') sums over a window, in
    seconds; `stream` sums are None on the CPU."""
    calls: int = 0
    host_s: float = 0.0
    host_self_s: float = 0.0
    stream_s: float = None
    stream_self_s: float = None

    def add(self, host, host_self, stream, stream_self):
        self.calls += 1
        self.host_s += host
        self.host_self_s += host_self
        if stream is not None:
            self.stream_s = (self.stream_s or 0.0) + stream
            self.stream_self_s = (self.stream_self_s or 0.0) + stream_self

    def time(self, field="stream"):
        """`stream_s`, or `host_s` where there is no stream time."""
        return self.stream_s if field == "stream" and \
            self.stream_s is not None else self.host_s


@dataclass
class Record:
    name: str
    id: object
    seq: int
    parent: int       # the parent's seq, or -1
    thread: int
    t0_ns: int
    t1_ns: int
    stream_s: float


class Window:
    """A window's sums.  `spans`: name -> Stats (self = the span less what
    its child spans cover); `children`: (parent, child) -> Stats of the
    direct children; `within`: (ancestor, name) -> Stats of the spans
    `name` at any depth below a span `ancestor`; `counters`: each
    counter's change; `evals` and `steps`: the `md.eval` and `train.step`
    spans; `records`: up to MAX_RECORDS raw spans, in the order they
    closed; `host_s`: the window's open time."""

    def __init__(self):
        self.spans = defaultdict(Stats)
        self.children = defaultdict(Stats)
        self.within = defaultdict(Stats)
        self.records = []
        self.counters = {}
        self.host_s = 0.0
        self.evals = self.steps = 0

    def total(self, prefixes, field="stream"):
        """Summed `field` time of the spans whose name starts with one of
        `prefixes`."""
        return sum(s.time(field) for n, s in self.spans.items()
                   if n.startswith(prefixes))

    def inside(self, outer, inner, field="stream", direct=False):
        """Summed `field` time of the spans `inner` (prefixes) below spans
        `outer` (prefixes): direct children only, or at any depth."""
        pairs = self.children if direct else self.within
        return sum(s.time(field) for (a, n), s in pairs.items()
                   if a.startswith(outer) and n.startswith(inner))


class _Span:
    __slots__ = ("name", "id", "rec")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        self.rec = _open(self.name, self.id)
        return self.rec

    def __exit__(self, *exc):
        if self.rec is not None:
            _close(self.rec)
        return False


class _Open:
    """A span in flight: open, or closed with events not yet resolved."""
    __slots__ = ("name", "id", "seq", "parent", "window", "stack", "thread",
                 "t0", "t1", "ev0", "ev1", "rf", "marker", "closed",
                 "child_host", "child_stream")


class _OpenWindow:
    def __init__(self):
        self.t0 = time.time_ns()
        self.counts0 = counters()
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        # the spans' events go on the stream current at the window's start
        self.stream = torch.cuda.current_stream() if self.cuda else None
        self.owner = _stack()
        self.pending = deque()     # closed spans, events unresolved
        self.markers = []          # open backward spans
        self.pool = []             # free CUDA events
        self.seq = 0
        self.out = Window()
        self.t1 = None
        self.done = False

    def event(self):
        ev = self.pool.pop() if self.pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def resolve(self, r):
        host = (r.t1 - r.t0) * 1e-9
        stream = None
        if r.ev0 is not None:
            stream = 1e-3 * r.ev0.elapsed_time(r.ev1)
            self.pool += (r.ev0, r.ev1)
            r.ev0 = r.ev1 = None
        out = self.out
        out.spans[r.name].add(host, host - r.child_host, stream,
                              None if stream is None
                              else stream - r.child_stream)
        p = r.parent
        if p is not None:
            p.child_host += host
            if stream is not None:
                p.child_stream += stream
            out.children[(p.name, r.name)].add(host, host, stream, stream)
        while p is not None:
            out.within[(p.name, r.name)].add(host, host, stream, stream)
            p = p.parent
        if len(out.records) < MAX_RECORDS:
            out.records.append(Record(
                r.name, r.id, r.seq, -1 if r.parent is None
                else r.parent.seq, r.thread, r.t0, r.t1, stream))

    def poll(self):
        q = self.pending
        while q and (q[0].ev1 is None or q[0].ev1.query()):
            self.resolve(q.popleft())

    def finish(self):
        """Resolve every closed span (waiting for the device) and return
        the window."""
        with _lock:
            if not self.done:
                q = self.pending
                if q and q[-1].ev1 is not None:
                    q[-1].ev1.synchronize()
                while q:
                    self.resolve(q.popleft())
                out = self.out
                out.host_s = ((self.t1 or time.time_ns()) - self.t0) * 1e-9
                out.evals = out.spans["md.eval"].calls \
                    if "md.eval" in out.spans else 0
                out.steps = out.spans["train.step"].calls \
                    if "train.step" in out.spans else 0
                self.pool.clear()
                self.done = True
            return self.out


def _stack():
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _open_window():
    global _window
    _window = _OpenWindow()
    return _window


def _end_window():
    """Close the open window (with _lock held, or from `span`)."""
    global _window, _last
    with _lock:
        w = _window
        if w is None:
            return
        _window = None
        w.t1 = time.time_ns()
        now = counters()
        w.out.counters = {k: v - w.counts0.get(k, 0) for k, v in now.items()
                          if v != w.counts0.get(k, 0)}
        _last = w


def _open(name, id, marker=False):
    with _lock:
        w = _window or _open_window()
        stack = _stack()
        if marker and stack and stack[-1].marker:
            _close(stack[-1])          # the last backward on this thread
        r = _Open()
        r.name, r.id, r.window, r.stack, r.marker = name, id, w, stack, marker
        r.parent = stack[-1] if stack else (w.owner[-1] if w.owner
                                            else None)
        r.seq = w.seq
        w.seq += 1
        r.thread = threading.get_ident()
        r.closed = False
        r.child_host = r.child_stream = 0.0
        r.rf = None
        if _profiling():
            r.rf = _annotation(name)
            r.rf.__enter__()
        r.t0 = time.time_ns()
        r.ev0 = w.event() if w.cuda else None
        r.ev1 = None
        stack.append(r)
        if marker:
            w.markers.append(r)
        return r


def _close(r):
    with _lock:
        if r.closed:
            return
        w = r.window
        for m in [m for m in w.markers if m.parent is r]:
            _close(m)                  # backward spans left open below it
        stack = r.stack
        while stack and stack[-1] is not r and r in stack:
            _close(stack[-1])
        if r.ev0 is not None:
            r.ev1 = w.event()
        r.t1 = time.time_ns()
        if r.rf is not None:
            r.rf.__exit__(None, None, None)
        r.closed = True
        if stack and stack[-1] is r:
            stack.pop()
        if r.marker:
            w.markers.remove(r)
        if w.done:
            return                      # the window was read already
        w.pending.append(r)
        if len(w.pending) > MAX_PENDING:
            w.poll()


# ---------------------------------------------------------------------------
# backward spans
# ---------------------------------------------------------------------------

def backward_span(name, id=None):
    """While the recorder is on, a function that passes a forward call's
    output (a tensor or a tuple of them) through the marker that opens the
    span `name` when the output's cotangent arrives; None when off."""
    if not (_forced or _profiling()):
        return None

    def mark(y):
        many = isinstance(y, (tuple, list))
        ys = tuple(y) if many else (y,)
        if not torch.is_grad_enabled() or not any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in ys):
            return y
        out = _Enter.apply((name, id), *ys)
        return tuple(out) if many else out[0]
    return mark


class _Enter(torch.autograd.Function):
    """Identity (views, no kernel) whose backward opens a backward span.
    The cotangents pass on as they came, so the sums autograd forms are
    those it forms without the marker."""

    @staticmethod
    def forward(ctx, key, *ys):
        ctx.set_materialize_grads(False)
        ctx.key = key
        return tuple(t.view_as(t) for t in ys)

    @staticmethod
    def backward(ctx, *gs):
        global _queued
        if on():
            _open(*ctx.key, marker=True)
            if not _queued:
                _queued = True
                torch.autograd.Variable._execution_engine.queue_callback(
                    _end_backward)
        return (None,) + gs


def _end_backward():
    """At the end of a backward pass: close its open backward spans."""
    global _queued
    _queued = False
    with _lock:
        w = _window
        for r in list(w.markers) if w is not None else ():
            _close(r)
