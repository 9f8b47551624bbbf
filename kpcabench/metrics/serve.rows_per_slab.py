"""Query rows scored per ``project`` launch in the traced window: the rows
the clients sent over the kernel's launch counter
(``project_tiles.launches``). Moves serve_rows_per_s."""


def read(ctx):
    launches = ctx.counters.get("project_launches")
    if ctx.digest is None or not launches:
        return None
    return ctx.counters["rows"] / launches
