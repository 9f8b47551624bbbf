"""Seconds a fit takes on the host's clock: an untraced window of the
run's length over the fits it completed, each ending in a synchronise.
The host loop's own number; its runs swing with the host's speed by
more than a bound holds, so it is read per layer and ``fit_device_s``
is the fit's bounded metric."""


def read(ctx):
    return ctx.counters.get("fit_wall_s")
