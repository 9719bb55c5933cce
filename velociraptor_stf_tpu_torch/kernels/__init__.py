"""Hand-written CUDA kernels, their plain PyTorch versions and launch counts.

Each wrapper (``fof_sweep.detect`` / ``sweep3d`` / ``sweep6d``,
``potential.potential``) runs its plain version for a tensor on the CPU and
launches its CUDA kernel for a tensor on a GPU; it never falls back from one
to the other.  ``LAUNCHES`` counts the CUDA launches of each kernel, so a
run can show that its main path went through the kernels.

Importing this package needs neither nvcc nor a GPU (``_build`` compiles the
library at the first launch).
"""

# Rows per thread block of every kernel (one row per thread); the plain
# versions and the coverage windows use the same row blocks.
R_BLOCK = 256

LAUNCHES = {"fof_detect": 0, "fof_sweep3d": 0, "fof_sweep6d": 0,
            "potential": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
