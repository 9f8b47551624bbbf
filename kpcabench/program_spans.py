"""The program's own spans in a traced window: which span launched each
device operation, and which span the host was in while the device sat
idle.

The port's tracer (``repro_torch.obs.trace``), while enabled, opens each
of its spans (``setup.*``, ``solver.*``, ``package.*``) as a
``record_function`` range whenever a torch profiler records: in the
profiler's events they are the CPU user annotations whose name lacks the
``kpcabench.`` prefix. ``program(events, launches(prof))`` gives:

  * ``program``: {span: {"n", "host_s", "device_s", "calls", "idle_s"}}.
    A device operation belongs to the innermost program span open on the
    host when its launch began: the CUDA runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) with the operation's correlation id, the
    port's own kernels' launches through ``ctypes`` included. The spans do
    not synchronise, so a kernel may start after its span has closed; it
    counts whole all the same. ``idle_s`` is the
    device's idle seconds in the traced window whose gap midpoint falls
    in the span as the innermost open program span (self time).
  * ``unattributed_s`` / ``unattributed_idle_s``: the device and idle
    seconds that no program span claims (an operation whose runtime call
    is not in the trace counts here).

A trace without program spans gives {}. ``READINGS`` holds the per-layer
metrics read from a digest that carries these keys, each ``read(ctx)`` as
in ``kpcabench/metrics/``, None without them.
"""

from __future__ import annotations

from kpcabench import tracing
from kpcabench.metrics import fits


def launches(prof) -> dict:
    """{device operation's correlation id: start of the CUDA call that
    launched it} in a profile, in the microseconds of ``prof.events()``.
    Read from the profiler's raw results, where a runtime or driver call
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) is a CPU event named
    ``cu*`` whose correlation id is its operation's. The name tells it
    from the CPU operations, whose ids are counted apart and can repeat
    the calls'; a call under no operation (a launch through ``ctypes``)
    has no ``linked_correlation_id``."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return {e.correlation_id(): (e.start_ns() - t0) / 1e3
            for e in res.events()
            if e.device_type() == DeviceType.CPU
            and e.name().startswith("cu")}


def _innermost(intervals, times) -> list:
    """For each time, the name of the innermost interval (start, end,
    name) open at it, or None. Intervals nest (one host thread); an
    interval holds its ends."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(ivs) and ivs[i][0] <= t:
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def _idle(window, device) -> list:
    """The window's (start, end) intervals in which no device operation
    runs."""
    w0, w1 = window
    gaps, t = [], w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def program(events, launched: dict) -> dict:
    """The program spans' record of a profiler's event list (times in
    microseconds; see above); ``launched``: ``launches(prof)``."""
    from torch.autograd import DeviceType
    prog, device, window = [], [], None
    for e in events:
        r = e.time_range
        user = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CPU:
            if e.name == tracing.WINDOW:
                window = (r.start, r.end)
            elif user and not e.name.startswith(tracing.PREFIX):
                prog.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CUDA and r.end > r.start \
                and not user and not e.name.startswith(tracing.PREFIX):
            device.append(e)
    if not prog:
        return {}
    rec = {}
    for s0, s1, name in prog:
        r = rec.setdefault(name, dict(n=0, host_s=0.0, device_s=0.0,
                                      calls=0, idle_s=0.0))
        r["n"] += 1
        r["host_s"] += (s1 - s0) / 1e6
    # Attribution by launch reads no device time, so every operation of the
    # trace counts whole.
    linked = [e for e in device if e.id in launched]
    unattributed = sum(e.time_range.end - e.time_range.start
                       for e in device if e.id not in launched) / 1e6
    owners = _innermost(prog, [launched[e.id] for e in linked])
    for e, owner in zip(linked, owners):
        sec = (e.time_range.end - e.time_range.start) / 1e6
        if owner is None:
            unattributed += sec
        else:
            rec[owner]["device_s"] += sec
            rec[owner]["calls"] += 1
    gaps = _idle(window, [(e.time_range.start, e.time_range.end)
                          for e in device])
    unclaimed_idle = 0.0
    for (a, b), owner in zip(gaps, _innermost(
            prog, [0.5 * (a + b) for a, b in gaps])):
        if owner is None:
            unclaimed_idle += (b - a) / 1e6
        else:
            rec[owner]["idle_s"] += (b - a) / 1e6
    return dict(program=rec, unattributed_s=unattributed,
                unattributed_idle_s=unclaimed_idle)


def _program(ctx):
    d = ctx.digest
    n = fits(ctx) if d is not None and "program" in d else 0
    return (d["program"], n) if n else (None, 0)


def _idle_ms(ctx, layer: str):
    prog, n = _program(ctx)
    if prog is None:
        return None
    return 1e3 * sum(r["idle_s"] for name, r in prog.items()
                     if name.startswith(layer + ".")) / n


def setup_eigh_ms(ctx):
    """Device milliseconds a fit's eigensolve launches (``setup.eigh``)."""
    prog, n = _program(ctx)
    if prog is None or "setup.eigh" not in prog:
        return None
    return 1e3 * prog["setup.eigh"]["device_s"] / n


def setup_idle_ms(ctx):
    """Device-idle milliseconds a fit while the host is in ``setup.*``."""
    return _idle_ms(ctx, "setup")


def solver_idle_ms(ctx):
    """Device-idle milliseconds a fit while the host is in ``solver.*``."""
    return _idle_ms(ctx, "solver")


def solver_iter_calls(ctx):
    """Device operations ``solver.iter`` (one ``admm_step`` call) launches
    an iteration."""
    prog, n = _program(ctx)
    if prog is None or "solver.iter" not in prog:
        return None
    return prog["solver.iter"]["calls"] / (n * ctx.config["iterations"])


READINGS = {"setup.eigh_ms": setup_eigh_ms, "setup.idle_ms": setup_idle_ms,
            "solver.idle_ms": solver_idle_ms,
            "solver.iter_calls": solver_iter_calls}

__all__ = ["READINGS", "launches", "program", "setup_eigh_ms",
           "setup_idle_ms", "solver_idle_ms", "solver_iter_calls"]
