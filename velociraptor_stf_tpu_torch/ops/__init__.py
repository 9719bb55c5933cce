"""Tensor operations of the port: cell grid, segment helpers, the sorted FOF
context and fixed point, and the group-sorted direct potential."""
