"""A traced window's digest (``tracing.digest``'s, key for key) read from
the profiler's raw results, for windows of hundreds of thousands of
device operations: a training step launches about 10^5, and building
``prof.events()`` for two of them takes minutes, where reading the raw
events takes seconds. Times are taken in microseconds from the trace's
start, as ``prof.events()`` gives them. Also the device's busy seconds
of a window traced for device activity alone, which is how an untraced
run takes an end-to-end metric from the device's trace."""

from __future__ import annotations

from kpcabench import tracing


def profiled(fn, sync):
    """fn() under the profiler (host and device activity) inside the
    window range, ``sync`` called before the range closes. Returns (fn's
    result, the digest)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW):
            out = fn()
            sync()
    return out, digest(prof.profiler.kineto_results)


def device_seconds(fn, sync):
    """fn() under the profiler with device activity alone, ``sync`` called
    before it stops. Returns (fn's result, the seconds in which any device
    operation ran: the union of kernel, copy and memset intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    intervals = [(e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and e.end_ns() > e.start_ns() and not e.is_user_annotation()]
    busy = tracing._merge(intervals)
    return out, sum(b - a for a, b in busy) / 1e9


def digest(results) -> dict:
    """``tracing.digest`` of a profiler's raw results."""
    from torch.autograd import DeviceType
    t0 = results.trace_start_ns()
    window, spans, host, device = None, [], [], []
    for e in results.events():
        a, b = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == tracing.WINDOW:
                window = (a, b)
            elif name.startswith(tracing.PREFIX):
                spans.append((a, b, name[len(tracing.PREFIX):]))
            else:
                host.append((a, b, name))
        elif e.device_type() == DeviceType.CUDA and b > a \
                and not e.is_user_annotation() \
                and not name.startswith(tracing.PREFIX):
            device.append((a, b, name))
    return tracing.digest_of(window, spans, host, device)


__all__ = ["device_seconds", "digest", "profiled"]
