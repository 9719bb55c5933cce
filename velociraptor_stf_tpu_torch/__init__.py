"""velociraptor_stf_tpu_torch: the halo finder's port to PyTorch and CUDA.

A second package beside the JAX reference ``velociraptor_stf_tpu``.  It
covers the main path that ``bench.py`` times -- 3DFOF -> 6DFOF -> field
unbinding (``models.pipeline.search_and_unbind``) -- with every Pallas TPU
kernel of that path rewritten as a hand-written CUDA kernel for Hopper
(``kernels/csrc``), and the halo catalog on top of it: properties and
spherical overdensities (``models.pipeline.find_structures``), the
command line (``python -m velociraptor_stf_tpu_torch.cli``) and the
library API (``api``).  Hydro snapshots take the pair pipeline
(``ops.fof``), the baryon association with its combined unbind
(``models.baryons``) and the per-type properties; the substructure
recursion (``models.substructure``: velocity density, background grid and
outliers, stream FOF, merger cores, level-wide unbind) and single-halo
mode run on the same path.  It keeps its
own copies of the host modules it needs (options and config parser,
cosmology, counters and timer in ``utils``; snapshot readers, catalog
writers, mocks and the density cache in ``io``; float64 oracles in
``validation``) and imports
neither jax nor anything of the JAX package.

Importing the package loads nothing heavy: the CUDA library is compiled on
the first kernel launch on a CUDA tensor.
"""

__version__ = "0.1.0"
