"""Share (%) of the recursion's merger-core laps (the
``substructure.cores`` spans of the traced catalogs) in which no
operation ran on the card: one minus the union of the device operations
inside them over their total length; nothing without the program's
spans."""

from benchmark.harness import spans


def read(ctx):
    cats = spans.traced(ctx)
    return None if cats is None else cats.idle_share("substructure.cores")
