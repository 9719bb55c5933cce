"""The recursion's merger-core lap, ``timings["subsub_cores"]`` (mean
over the window's catalogs)."""


def read(ctx):
    return ctx.stage_mean("subsub_cores")
