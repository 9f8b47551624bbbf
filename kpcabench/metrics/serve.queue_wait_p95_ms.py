"""95th percentile of the engine's own submit-to-serve queue wait
(``EngineStats.per_request``, its ring of recent requests) over the
traced window's requests it still holds. Moves serve_p95_ms."""


def read(ctx):
    if ctx.digest is None:
        return None
    return ctx.counters.get("queue_wait_p95_ms")
