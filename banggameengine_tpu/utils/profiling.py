"""Profiling/tracing helpers.

Replaces the reference's hand-rolled timers (frame timer ``Time.cpp:16-29``,
physics step wall-time around ``stepSimulation`` at
``PhysicsSystem.cpp:862-867``, F9 stats ``:1330-1341``) and the stubbed bgfx
profiler hooks (``Renderer.cpp:44-46``) with:

- :class:`StepTimer`: wall-time accumulator with min/max/mean and an
  F9-style report line;
- :func:`measure_trials` / :func:`measure_trials_chained`: dispatch-rate
  timing windows that end in ``jax.block_until_ready``;
- :func:`device_op_seconds` / :func:`scope_seconds`: device time per HLO
  instruction and per ``jax.named_scope`` from a profiler trace;
- :func:`trace_annotation`: ``jax.profiler.TraceAnnotation`` context for
  device-timeline traces (viewable in TensorBoard/XProf);
- :func:`start_trace` / :func:`stop_trace`: whole-program device traces.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

# `%name = <shape> <opcode>(...), ..., metadata={op_name="..." ...}`
_HLO_OP_RE = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                        r'metadata=\{[^}]*?op_name="([^"]*)"', re.M)


class StepTimer:
    """Accumulates wall-clock timings for a named phase."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self.min = float("inf")
        self.max = 0.0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.last = dt
            self.total += dt
            self.count += 1
            self.min = min(self.min, dt)
            self.max = max(self.max, dt)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def report(self) -> str:
        if not self.count:
            return f"[{self.name}] no samples"
        return (
            f"[{self.name}] last={self.last * 1e3:.3f}ms "
            f"mean={self.mean * 1e3:.3f}ms min={self.min * 1e3:.3f}ms "
            f"max={self.max * 1e3:.3f}ms n={self.count}"
        )


def measure_trials(fn, *args, calls: int = 5, warmup: int = 2,
                   trials: int = 5):
    """Per-call seconds of a NON-donating jitted fn over ``trials``
    independent timed windows of ``calls`` queued dispatches, each window
    ending in ``jax.block_until_ready``."""
    import time as _time

    import jax

    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(max(trials, 1)):
        t0 = _time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((_time.perf_counter() - t0) / calls)
    return times


def measure_trials_chained(fn, state, *rest, calls: int = 5,
                           warmup: int = 2, trials: int = 5):
    """:func:`measure_trials` for (possibly donating) step-like fns.

    ``fn(state, *rest)`` must return the next state (or a tuple whose first
    element is).  Returns ``(per_call_seconds_list, final_state)``; report
    the median and spread of the list, since one window cannot tell a
    regression from noise.
    """
    import time as _time

    import jax

    def step(s):
        out = fn(s, *rest)
        return out[0] if isinstance(out, tuple) else out

    for _ in range(max(warmup, 1)):
        state = step(state)
    jax.block_until_ready(state)
    times = []
    for _ in range(max(trials, 1)):
        t0 = _time.perf_counter()
        for _ in range(calls):
            state = step(state)
        jax.block_until_ready(state)
        times.append((_time.perf_counter() - t0) / calls)
    return times, state


def device_op_seconds(trace_dir: str) -> dict[str, float]:
    """Device seconds per HLO instruction in the newest profiler trace under
    ``trace_dir`` (``jax.profiler.trace(trace_dir)``): durations of every
    event on a ``/device:`` plane, keyed by the event's ``hlo_op`` stat (or
    its name when it has none)."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no profiler trace under {trace_dir}")
    planes = list(ProfileData.from_file(paths[-1]).planes)
    devices = [p for p in planes if p.name.startswith("/device:")]
    out: dict[str, float] = {}
    # the CPU backend has no device plane: its ops run on host threads and
    # carry an ``hlo_op`` stat
    for plane in devices or planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if not devices and "hlo_op" not in stats:
                    continue
                name = str(stats.get("hlo_op", ev.name))
                out[name] = out.get(name, 0.0) + ev.duration_ns * 1e-9
    return out


def hlo_op_scopes(hlo_text: str) -> dict[str, str]:
    """Instruction name -> ``op_name`` metadata (the ``jax.named_scope``
    path) for every instruction of a compiled module's text
    (``jitted.lower(...).compile().as_text()``)."""
    out = {}
    for m in _HLO_OP_RE.finditer(hlo_text):
        out[m.group(1)] = m.group(2)
    return out


def scope_seconds(op_seconds: dict[str, float], hlo_text: str,
                  scope: str) -> float:
    """Device seconds of the instructions whose ``op_name`` metadata lies
    under the named scope ``scope``."""
    scopes = hlo_op_scopes(hlo_text)
    tag = f"/{scope}/"
    return sum(t for op, t in op_seconds.items()
               if tag in "/" + scopes.get(op, "") + "/")


def gpu_name_and_power_limit() -> str:
    """The cards' name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a note when nvidia-smi is unavailable)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def trace_annotation(name: str):
    """Named region on the device trace timeline."""
    import jax.profiler

    return jax.profiler.TraceAnnotation(name)


def start_trace(log_dir: str) -> None:
    import jax.profiler

    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    import jax.profiler

    jax.profiler.stop_trace()
