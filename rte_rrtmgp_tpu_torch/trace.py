"""Host spans and counters of the port: where the host spends a step.

``span(name)`` marks a stretch of host work (``spanned(name)`` each call
of a function), ``wait(site)`` a call that makes the host wait for the
device (a device-to-host read, a copy from pageable host memory). Both
are context managers. Tracing is off unless a :func:`collect` block is
open, and off they return one shared object whose ``__enter__`` and
``__exit__`` do nothing: the cost is one call and one check of a module
global (no clock read, no allocation, no
``torch.profiler.record_function``).

Inside ``with collect() as rec:`` every span closed is kept in memory as
a row ``(name, request, parent, thread, t0_ns, t1_ns)``:

  * ``parent`` is the name of the span open around it on its thread, or
    None;
  * a span opened with no parent on its thread starts a request: it
    takes the next request number and the spans inside it share it. The
    stacks are per thread, because autograd runs a CUDA backward on a
    thread of its own;
  * times are ``time.perf_counter_ns()``. ``rec.clock`` holds two pairs
    ``(perf_counter_ns, time_ns)`` read at the block's start and end, and
    ``rec.epoch_ns`` maps a span's time onto the Unix-epoch clock of a
    ``torch.profiler`` trace through them.

``rec.counters`` holds ``waits`` (the calls of :func:`wait` inside the
block), ``launches.<kernel>``: how far each hand-written kernel
wrapper's ``.launches`` count (``ops/kernels/*``) moved during the
block, read at its start and end, and what :func:`count` added (the
whole-grid stream's ``stream.*`` counters).

Span names follow the layers: ``allsky.lw`` and the other entry points,
``gas.*`` (the gas optics' input prep), ``check.*`` (value checks),
``cloud.optics``, ``aerosol.optics``, ``optics.*``, ``sources.planck``, ``rte.lw``/``rte.sw``
(the public front ends), ``stream.*`` (the whole-grid stream's sweep,
uploads, chunks, day gathers and readbacks, ``parallel/scaling.py``),
``kernel.<name>`` (the host's dispatch of one hand-written kernel),
``backward.<name>`` (its gradient, on autograd's thread) and
``wait.<site>``.
"""
from __future__ import annotations

import functools
import importlib
import pkgutil
import threading
import time
from contextlib import contextmanager

__all__ = ["span", "spanned", "wait", "count", "collect", "Recorder"]

_rec = None                   # the open collect() block's recorder
_local = threading.local()    # .stack: the thread's open spans


class _Off:
    """The span returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "request", "parent", "t0")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1].name
            self.request = stack[-1].request
        else:
            self.parent = None
            self.request = self.rec._next_request()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        self.rec.spans.append((self.name, self.request, self.parent,
                               threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context manager marking host work ``name``; a shared no-op while
    tracing is off."""
    if _rec is None:
        return _OFF
    return _Span(_rec, name)


def spanned(name: str):
    """A decorator: each call of the function in the span ``name``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _rec is None:
                return fn(*args, **kwargs)
            with _Span(_rec, name):
                return fn(*args, **kwargs)
        return call
    return decorate


def wait(site: str):
    """The span ``wait.<site>`` around a call that makes the host wait for
    the device; counts one in ``waits``. A shared no-op while tracing is
    off."""
    rec = _rec
    if rec is None:
        return _OFF
    with rec._lock:
        rec.counters["waits"] += 1
    return _Span(rec, "wait." + site)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``; nothing while tracing is off."""
    rec = _rec
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def _launch_counts() -> dict:
    """``.launches`` of every hand-written kernel wrapper, by name."""
    from .ops import kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[name] = n
    return out


class Recorder:
    """What one :func:`collect` block recorded: ``spans``, ``counters``
    and ``clock`` (see the module's notes)."""

    def __init__(self):
        self.spans = []
        self.counters = {"waits": 0}
        self.clock = []
        self._requests = 0
        self._lock = threading.Lock()

    def _next_request(self) -> int:
        with self._lock:
            self._requests += 1
            return self._requests

    def epoch_ns(self, t_ns: int) -> float:
        """``time.perf_counter_ns()`` value ``t_ns`` on the Unix-epoch
        clock, linear between the block's two clock pairs."""
        (p0, e0), (p1, e1) = self.clock
        slope = (e1 - e0) / (p1 - p0) if p1 > p0 else 1.0
        return e0 + (t_ns - p0) * slope


def _clock_pair():
    return time.perf_counter_ns(), time.time_ns()


@contextmanager
def collect():
    """Turn tracing on for the block; yields its :class:`Recorder`. Blocks
    do not nest."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace.collect: a collect() block is already open")
    rec = Recorder()
    before = _launch_counts()
    rec.clock.append(_clock_pair())
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec.clock.append(_clock_pair())
        for name, n in _launch_counts().items():
            rec.counters["launches." + name] = n - before.get(name, 0)
