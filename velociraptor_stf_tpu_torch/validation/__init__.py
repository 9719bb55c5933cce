"""Float64 oracles that the port is held to (a copy of the JAX
package's)."""
