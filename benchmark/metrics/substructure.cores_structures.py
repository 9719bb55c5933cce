"""Structures whose merger cores were searched (the
``substructure.cores.structure`` spans), a traced catalog: the cores'
work as a count; nothing without the program's spans."""

from benchmark.harness import spans


def read(ctx):
    cats = spans.traced(ctx)
    return None if cats is None else \
        cats.count("substructure.cores.structure")
