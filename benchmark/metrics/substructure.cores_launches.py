"""Kernel launch calls starting inside the recursion's merger-core laps
(the ``substructure.cores`` spans), a traced catalog; nothing without
the program's spans."""

from benchmark.harness import spans


def read(ctx):
    cats = spans.traced(ctx)
    return None if cats is None else \
        cats.host_calls("substructure.cores", "launches")
