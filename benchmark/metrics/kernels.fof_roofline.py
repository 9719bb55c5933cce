"""Share (%) of the roofline that the 3D FOF kernels (``detect_kernel``,
``sweep3d_kernel``) reach in the traced catalogs: the launches' least
times from the work the benchmark counts (``roofline/fof.py``) over
their device times from the trace.  Nothing where no launch was
traced."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    det = tr.kernel_times("detect_kernel")
    swp = tr.kernel_times("sweep3d_kernel")
    if len(det) + len(swp) == 0:
        return None
    work = ctx.fof_work()
    bound = len(det) * work.detect_bound_s() + \
        len(swp) * work.sweep3d_bound_s()
    return 100.0 * bound / float(det.sum() + swp.sum())
