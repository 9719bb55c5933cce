"""Seconds a catalog spends in ``find_structures`` outside its timed
stages: the transfer in, the catalog's copies out and host work between
stages (mean over the window's catalogs)."""


def read(ctx):
    return ctx.mean_over_catalogs(lambda wall, t: ctx.outside(wall, t))
