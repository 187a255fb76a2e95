"""Spans and counters of the port's own work, off unless asked for.

`span(name)` marks a stretch of code and `count(name, n)` adds to a counter
of the call it runs in (kernels/build.launch counts each kernel launch);
`call(name, hook)` opens the root span of one call and carries its phase
hook, which each `stage(name, hook_name)` span of the call calls where it
ends. Tracing is on between `enable()` and `disable()`, and, without them,
for the length of each call opened while a torch.profiler records (the
profiler then carries the spans in its own trace). Off, `span` hands back
one shared no-op context, as `call` and `stage` do without a hook, and
`count` returns after one flag check: no synchronization, no device
memory, no allocation.

On, each span is also entered as torch.profiler.record_function(name), so
a profiled window carries the spans on the trace's own clock, and it is
kept in memory: its name, its start and end in Unix-epoch nanoseconds (the
clock of a chrome trace's ts + baseTimeNanoseconds / 1000), its parent
(the innermost open span of the same thread), its call (the root it runs
under: on the same thread, or on a worker thread started by the root's
thread, the innermost open root) and its thread. A counter adds to the
call of the innermost open span. `drain()` hands over what was kept and
forgets it; `totals()` reads the counters without forgetting them.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

READBACKS = "engine.readbacks"  # device-to-host copies a call makes
# rows the dictionary's doubling passes to a sort, its seed sort included
DICT_SORT_ROWS = "pfp.dict.sort_rows"
# pairs the dictionary's LCP gathers by rank descent, one level at a time
# (the packed bottom counts as one level)
DICT_DESCENT_ROWS = "pfp.dict.descent_rows"

_NOOP = contextlib.nullcontext()
_enabled = False   # between enable() and disable()
_auto = 0          # calls open because a torch.profiler records
_on = False        # _enabled or _auto: the one flag the off path reads
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_spans: list = []       # every span opened since the last drain
_calls: list = []       # the roots open on any thread, innermost last
_counters: dict = {}    # (call id or None, name) -> count


def enable() -> bool:
    """Record every span and counter until disable(); returns whether
    tracing was enabled already."""
    global _enabled, _on
    with _lock:
        was, _enabled, _on = _enabled, True, True
    return was


def disable() -> None:
    global _enabled, _on
    with _lock:
        _enabled = False
        _on = _auto > 0


def drain() -> dict:
    """What was kept since the last drain, forgotten here: {"spans": [one
    dict a span, in the order they opened: id, name, start_ns, end_ns
    (None while open), parent, call (ids, or None), thread], "counters":
    {call id (None outside any call): {name: count}}}."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    out = {}
    for (call_id, name), n in counters.items():
        out.setdefault(call_id, {})[name] = n
    return {"spans": [s.record() for s in spans], "counters": out}


def totals() -> dict:
    """{counter name: its count over every call} of what was kept since the
    last drain, which stays kept."""
    out = {}
    with _lock:
        for (_call, name), n in _counters.items():
            out[name] = out.get(name, 0) + n
    return out


def _current_call(stack: list):
    if stack:
        return stack[-1].call
    return _calls[-1].id if _calls else None


class _Span:
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "call",
                 "thread", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.end_ns = None

    def __enter__(self):
        import torch
        stack = _local.__dict__.setdefault("stack", [])  # this thread's
        self.parent = stack[-1].id if stack else None
        self.call = _current_call(stack)
        self.thread = threading.get_ident()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        stack.append(self)
        with _lock:
            _spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _local.stack.pop()
        self._rf.__exit__(*exc)
        self._rf = None
        return False

    def record(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent,
                "call": self.call, "thread": self.thread}


class _Call(_Span):
    """A root: the span of one call, which its spans and counters name."""
    __slots__ = ("_auto",)

    def __init__(self, name: str, auto: bool):
        super().__init__(name)
        self._auto = auto

    def __enter__(self):
        global _auto, _on
        with _lock:
            if self._auto:
                _auto += 1
                _on = True
            _calls.append(self)
        super().__enter__()
        self.call = self.id
        return self

    def __exit__(self, *exc):
        global _auto, _on
        super().__exit__(*exc)
        with _lock:
            _calls.remove(self)
            if self._auto:
                _auto -= 1
                _on = _enabled or _auto > 0
        return False


def span(name: str):
    """A context that marks the code it holds as `name` when tracing is
    on, else the shared no-op context."""
    if not _on:
        return _NOOP
    return _Span(name)


def call(name: str, hook=None):
    """The root span of one call, which carries the call's phase hook
    (hook(name) is called where each of its stages ends): recorded when
    tracing is enabled or a torch.profiler records (then tracing is on
    until it closes); else the hook alone, or, without one, the shared
    no-op context."""
    import torch
    # the profiler's own switch (torch.profiler.profile and the autograd
    # profiler both set it); there is no public query
    if _enabled or torch._C._autograd._profiler_enabled():
        root = _Call(name, auto=not _enabled)
    elif hook is None:
        return _NOOP
    else:
        root = _NOOP
    return _hooked(root, hook)


@contextlib.contextmanager
def _hooked(root, hook):
    hooks = _local.__dict__.setdefault("hooks", [])  # this thread's calls'
    hooks.append(hook)
    try:
        with root as opened:
            yield opened
    finally:
        hooks.pop()


def stage(name: str, hook_name: str):
    """A stage of the call open on this thread: the span `name` and then,
    when its body ends without raising, the call's hook with hook_name,
    on this thread. With tracing off and no hook, the shared no-op
    context."""
    hooks = getattr(_local, "hooks", None)
    hook = hooks[-1] if hooks else None
    if hook is None and not _on:
        return _NOOP
    return _stage(span(name), hook, hook_name)


@contextlib.contextmanager
def _stage(marked, hook, hook_name: str):
    with marked:
        yield
    if hook is not None:
        hook(hook_name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the call the innermost open span
    belongs to (None outside any call)."""
    if not _on:
        return
    key = (_current_call(getattr(_local, "stack", None) or []), name)
    with _lock:
        _counters[key] = _counters.get(key, 0) + n
