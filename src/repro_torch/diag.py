"""Runtime hot-path guards: host-sync tripwires.

The port of ``repro/diag.py``. The closed loop keeps its latency targets
only while one contract holds: **one host sync per replan**. Candidate
arbitration, fleet simulation and each iteration of the merged solver stay
on the device; results cross to the host at deliberate materialization
points (``batched_rollout_scores``'s argmin, the solver's stop test).

Everything here is inert unless ``REPRO_DIAG=1`` (read on every call, so a
test can flip it with ``monkeypatch.setenv``): a disarmed :func:`hot_path`
costs one ``os.environ`` lookup.

Armed, :func:`hot_path` (a decorator or a context manager, re-entrant)
does two things for the region:

* on a machine with CUDA, ``torch.cuda.set_sync_debug_mode("error")``:
  every operation that synchronizes the host with the device (``.item()``,
  ``float(t)``, a blocking copy in either direction, ``synchronize``)
  raises. The previous mode comes back on exit, exceptions included. Move
  host data to the device before the region, as the guarded entry points
  do.
* a **numpy materialization tripwire**: ``np.asarray`` / ``np.array`` /
  ``np.asanyarray`` / ``np.ascontiguousarray`` raise :class:`HostSyncError`
  when handed a ``torch.Tensor``. This bites on the CPU too, where no
  copy synchronizes anything, and catches the repo's dominant host-sync
  idiom on every device.

The reference's ``CompileWatcher`` and ``RecompileError`` watch its
just-in-time compiler's executable caches; the port compiles no program per
shape, so they have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "HostSyncError",
    "HotPathStats",
    "enabled",
    "hot_path",
    "hot_path_registry",
]


class HostSyncError(RuntimeError):
    """A guarded hot path materialized a tensor on the host."""


def enabled() -> bool:
    """True when runtime diagnostics are armed (``REPRO_DIAG=1``).

    Read from the environment on every call: cheap, and lets tests flip
    the switch after import with ``monkeypatch.setenv``.
    """
    return os.environ.get("REPRO_DIAG", "").strip().lower() in {
        "1", "true", "on", "yes",
    }


# ---------------------------------------------------------------------------
# Hot-path registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "HotPathStats"] = {}
_LOCK = threading.Lock()


@dataclasses.dataclass
class HotPathStats:
    """Per-label call accounting for a registered hot path."""

    label: str
    calls: int = 0
    guarded_calls: int = 0


def hot_path_registry() -> dict[str, HotPathStats]:
    """Live view of every registered hot path (label -> stats)."""
    return _REGISTRY


def _stats(label: str) -> HotPathStats:
    with _LOCK:
        return _REGISTRY.setdefault(label, HotPathStats(label))


# ---------------------------------------------------------------------------
# The two guards.
# ---------------------------------------------------------------------------

_NP_FUNCS = ("asarray", "array", "asanyarray", "ascontiguousarray")
_tripwire_depth = 0


@contextlib.contextmanager
def _numpy_tripwire(label: str):
    """Patch numpy's materializers to reject ``torch.Tensor`` inputs.

    Re-entrant (nested hot paths patch once); single-threaded by design:
    REPRO_DIAG is a diagnostics mode, not a production default.
    """
    global _tripwire_depth
    if _tripwire_depth > 0:
        _tripwire_depth += 1
        try:
            yield
        finally:
            _tripwire_depth -= 1
        return

    originals = {name: getattr(np, name) for name in _NP_FUNCS}

    def _make(name: str, orig: Callable):
        @functools.wraps(orig)
        def guarded(a, *args, **kwargs):
            if isinstance(a, torch.Tensor):
                raise HostSyncError(
                    f"np.{name}() materialized a tensor inside the guarded "
                    f"hot path {label!r}: device values must stay on the "
                    f"device here (one host sync per replan). Move the "
                    f"materialization outside the hot path."
                )
            return orig(a, *args, **kwargs)

        return guarded

    _tripwire_depth += 1
    for name, orig in originals.items():
        setattr(np, name, _make(name, orig))
    try:
        yield
    finally:
        _tripwire_depth -= 1
        for name, orig in originals.items():
            setattr(np, name, orig)


@contextlib.contextmanager
def _cuda_sync_guard():
    """``set_sync_debug_mode("error")`` for the region, where CUDA exists;
    the previous mode is restored on exit."""
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


# ---------------------------------------------------------------------------
# hot_path: decorator / context manager arming both guards.
# ---------------------------------------------------------------------------


class _HotPathGuard:
    """Armed form of :func:`hot_path`: usable with ``with`` or as a
    decorator."""

    def __init__(self, label: str):
        self.label = label
        self._stack: list[contextlib.ExitStack] = []

    def __enter__(self):
        stats = _stats(self.label)
        stats.calls += 1
        stack = contextlib.ExitStack()
        if enabled():
            stats.guarded_calls += 1
            stack.enter_context(_cuda_sync_guard())
            stack.enter_context(_numpy_tripwire(self.label))
        self._stack.append(stack)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._stack.pop().close()
        return False

    def __call__(self, fn: Callable) -> Callable:
        label = self.label or f"{fn.__module__}.{fn.__qualname__}"
        guard = _HotPathGuard(label)

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            with guard:
                return fn(*args, **kwargs)

        _stats(label)
        return wrapper


def hot_path(label: str | None = None) -> _HotPathGuard:
    """Mark a device hot path; its guards arm only under ``REPRO_DIAG=1``.

    Usable two ways::

        @hot_path("serving.batched_rollout_scores")
        def batched_rollout_scores(...): ...

        with hot_path("core.solve_merged"):
            ...  # one solver iteration's device body

    Registration is unconditional (the decorator registers its label at
    definition, the context manager at first entry).
    """
    return _HotPathGuard(label or "")
