"""velociraptor_stf_tpu_torch: the halo finder's port to PyTorch and CUDA.

A second package beside the JAX reference ``velociraptor_stf_tpu``.  It
covers the main path that ``bench.py`` times -- 3DFOF -> 6DFOF -> field
unbinding (``models.pipeline.search_and_unbind``) -- with every Pallas TPU
kernel of that path rewritten as a hand-written CUDA kernel for Hopper
(``kernels/csrc``), and the halo catalog on top of it: properties and
spherical overdensities (``models.pipeline.find_structures``) and the
command line (``python -m velociraptor_stf_tpu_torch.cli``).  It reuses the
reference's jax-free modules (options and config parser, cosmology, snapshot
readers, catalog writers, mocks, float64 oracles) and never imports jax.

Importing the package loads nothing heavy: the CUDA library is compiled on
the first kernel launch on a CUDA tensor.
"""

__version__ = "0.1.0"
