"""The program's options for a cell: the configuration's shipped config,
parsed by the port's own parser, completed as the port's CLI completes
them from a snapshot header (``cli.py::read_snapshot``)."""

from __future__ import annotations

import os
import tempfile


def build_options(cfg: dict, snap, n_total: int):
    """``Options`` for configuration ``cfg`` (its file's JSON) on
    snapshot ``snap``: the ``cfg`` lines through
    ``utils/config.py::parse_config_file`` and ``config_check``, then the
    header's values: the scale factor, the box as the period and the mean
    interparticle spacing of all ``n_total`` particles as the linking
    lengths' scale."""
    from velociraptor_stf_tpu_torch.utils import config as C
    from velociraptor_stf_tpu_torch.utils import units

    fd, path = tempfile.mkstemp(suffix=".cfg")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write("\n".join(cfg["cfg"]) + "\n")
        opt = C.parse_config_file(path)
    finally:
        os.unlink(path)
    C.config_check(opt)
    opt.a = float(snap.a) if opt.icosmologicalin else 1.0
    opt.ellxscale = units.interparticle_spacing(snap.boxsize, n_total)
    opt.p = snap.boxsize
    return opt
