"""The baryon association and combined unbind, ``timings["baryons"]``
(mean over the window's catalogs); nothing where no catalog ran it."""


def read(ctx):
    return ctx.stage_mean("baryons")
