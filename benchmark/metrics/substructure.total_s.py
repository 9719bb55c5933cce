"""The substructure recursion's stage time, ``timings["substructure"]``
(mean over the window's catalogs)."""


def read(ctx):
    return ctx.stage_mean("substructure")
