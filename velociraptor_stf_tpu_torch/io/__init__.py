"""Snapshot readers, catalog writers and mocks (copies of the JAX
package's numpy modules)."""
