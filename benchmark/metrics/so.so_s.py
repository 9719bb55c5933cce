"""The spherical-overdensity stage's time, ``timings["so"]`` (mean over
the window's catalogs)."""


def read(ctx):
    return ctx.stage_mean("so")
