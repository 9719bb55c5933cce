"""The field search's stage time, ``timings["fof"]`` (mean over the
window's catalogs)."""


def read(ctx):
    return ctx.stage_mean("fof")
