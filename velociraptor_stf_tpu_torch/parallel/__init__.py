"""Multi-device mode of the port: a mesh of shards, the collectives that
move data between them, and the sharded stages (slab FOF with ghost
exchange, whole-groups unbind and properties, reduced SO histograms,
sharded velocity density, structure deal of the recursion, slab baryon
association)."""
