"""Set-up spent capturing CUDA graphs and loading the kernels: the seconds
of the program's ``graph_capture`` and ``kernel_load`` phases
(``utils/tracing``'s registry, kept from process start) by the time the
run is read. The kernels' build (``kernel_build``, only where the library
is not built yet) is left out. None where the program times neither."""


def read(ctx):
    try:
        from zonos_vibes_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.timings_snapshot()
    got = [snap[n]["total_s"] for n in ("graph_capture", "kernel_load") if n in snap]
    return sum(got) if got else None
