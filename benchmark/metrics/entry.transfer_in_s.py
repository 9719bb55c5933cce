"""Seconds a catalog spends copying its particles to the card,
``timings["to_device"]``: the entry's copies of positions, velocities,
masses and types, and the hydro fields' copy at the property stage (mean
over the window's catalogs); nothing where the program does not time
them."""


def read(ctx):
    return ctx.stage_mean("to_device")
