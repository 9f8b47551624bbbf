"""What a traced run reads from ``torch.profiler``: a digest of the device
timeline of one traced window.

The benchmark brackets its calls into the program in ``record_function``
ranges named ``kpcabench.<span>`` and synchronises at their ends, so a
device operation belongs to the span in which it started. The digest
holds:

  * ``window_s``: the traced window's length (its host range);
  * ``busy_s``: the seconds in which any device operation ran (the union
    of kernel, copy and memset intervals, clipped to the window);
  * ``ops``: {device operation: [calls, seconds]};
  * ``spans``: {span: {"n", "host_s", "busy_s", "calls"}};
  * ``gaps``: the device's idle seconds by what the host was doing, the
    innermost benchmark span and the innermost host operation at each
    gap's middle, largest first.

It is plain JSON, so a rank process can hand it to the process that
prints the result.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

WINDOW = "kpcabench.window"
PREFIX = "kpcabench."
TOP = 10
KERNELS = Path(__file__).resolve().parent / "kernels"


def profiled(fn, sync):
    """fn() under the profiler (host and device activity) inside the
    window range, ``sync`` called before the range closes. Returns (fn's
    result, the digest)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            sync()
    return out, digest(prof.events())


def span(name: str):
    """A benchmark span: a ``record_function`` range named
    ``kpcabench.<name>``."""
    from torch.profiler import record_function
    return record_function(PREFIX + name)


def _merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def digest(events) -> dict:
    """The digest of a profiler's event list (times in microseconds)."""
    from torch.autograd import DeviceType
    window, spans, host, device = None, [], [], []
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (r.start, r.end)
            elif e.name.startswith(PREFIX):
                spans.append((r.start, r.end, e.name[len(PREFIX):]))
            else:
                host.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CUDA and r.end > r.start \
                and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith(PREFIX):
            device.append((r.start, r.end, e.name))
    return digest_of(window, spans, host, device)


def digest_of(window, spans, host, device) -> dict:
    """The digest of a traced window's (start, end) and its benchmark
    spans, host operations and device operations, each (start, end,
    name), in microseconds."""
    if window is None:
        raise RuntimeError("the traced window's range is not in the trace")
    w0, w1 = window
    device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                    if b > w0 and a < w1)
    ops = {}
    for a, b, n in device:
        rec = ops.setdefault(n, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) / 1e6
    busy = _merge([(a, b) for a, b, _ in device])
    starts = [a for a, _, _ in device]
    per_span = {}
    for s0, s1, name in spans:
        lo, hi = bisect.bisect_left(starts, s0), bisect.bisect_right(starts,
                                                                     s1)
        inside = _merge([(a, b) for a, b, _ in device[lo:hi]])
        rec = per_span.setdefault(name, dict(n=0, host_s=0.0, busy_s=0.0,
                                             calls=0))
        rec["n"] += 1
        rec["host_s"] += (s1 - s0) / 1e6
        rec["busy_s"] += sum(b - a for a, b in inside) / 1e6
        rec["calls"] += hi - lo
    return dict(window_s=(w1 - w0) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                ops=ops, spans=per_span,
                gaps=_gaps(busy, (w0, w1), spans, host))


def _gaps(busy, window, spans, host) -> list:
    """Idle device seconds summed by label (span: host operation), the
    TOP largest."""
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    by_label = {}
    span_stack, host_stack = [], []
    spans = sorted(spans)
    host = sorted(host)
    si = hi = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while si < len(spans) and spans[si][0] <= mid:
            span_stack.append(spans[si])
            si += 1
        while hi < len(host) and host[hi][0] <= mid:
            host_stack.append(host[hi])
            hi += 1
        while span_stack and span_stack[-1][1] < mid:
            span_stack.pop()
        while host_stack and host_stack[-1][1] < mid:
            host_stack.pop()
        where = span_stack[-1][2] if span_stack else "window"
        what = host_stack[-1][2] if host_stack else "python"
        label = f"{where}: {what}"
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by_label.items()),
                  key=lambda kv: -kv[1])[:TOP]


def op_names() -> dict:
    """{op: [kernel name fragments]} from ``kernels/<op>.json``."""
    return {json.loads(p.read_text())["op"]: json.loads(p.read_text())[
        "kernels"] for p in sorted(KERNELS.glob("*.json"))}


def op_seconds(dig: dict, op: str) -> float:
    """Device seconds of the kernels that ``kernels/<op>.json`` names."""
    names = op_names()[op]
    return sum(sec for name, (_, sec) in dig["ops"].items()
               if any(k in name for k in names))


def breakdown(dig: dict) -> dict:
    """The line's ``breakdown``: the device operations that took most time
    (named ``<op>: <kernel>`` where ``kernels/`` names the op) and the
    longest idle gaps by what the host was doing."""
    names = op_names()

    def label(name):
        ops = [op for op, frags in names.items()
               if any(k in name for k in frags)]
        short = name if len(name) <= 96 else name[:93] + "..."
        return f"{'/'.join(ops)}: {short}" if ops else short

    top = sorted(dig["ops"].items(), key=lambda kv: -kv[1][1])[:TOP]
    return dict(device_ops=[[label(n), sec] for n, (_, sec) in top],
                idle_gaps=[list(g) for g in dig["gaps"]])


__all__ = ["WINDOW", "breakdown", "digest", "digest_of", "op_names",
           "op_seconds", "profiled", "span"]
