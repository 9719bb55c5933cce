"""Host calls that wait for the card (``benchmark/spread.py``'s
``WAITS``: synchronise, copy) starting inside the traced catalogs'
``catalog`` spans, a catalog; nothing without the program's spans."""

from benchmark.harness import spans


def read(ctx):
    cats = spans.traced(ctx)
    return None if cats is None else cats.host_calls("catalog", "waits")
