"""The property stage's time, ``timings["properties"]`` (mean over the
window's catalogs)."""


def read(ctx):
    return ctx.stage_mean("properties")
