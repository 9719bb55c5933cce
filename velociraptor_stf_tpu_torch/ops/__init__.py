"""Tensor operations of the port: cell grid, segment helpers, the sorted FOF
context and fixed point, the group-sorted direct potential, the bucket tree
for very large groups and the all-particle spherical overdensities."""
