"""Kernel 7, one Gauss-Seidel iteration of ``ops/sinkhorn.py::sinkhorn_iteration``
(``csrc/sinkhorn.cu``: ``sinkhorn_iter_kernel`` and its column pass): the
(B, M, N) float32 couplings read once, the potentials read and written
once. Bound by bytes (its few operations an element are far below the
float32 peak), as the kernel table of PERF.md counts it: all M x N
couplings, which a design must read."""

from harness.peaks import bound_s

WRAPS = ("deep_image_matching_tpu_torch.ops.sinkhorn", "sinkhorn_iteration")
DEVICE_NAMES = r"sinkhorn_iter_kernel|sinkhorn_cols_kernel"


def note(args, kwargs, out):
    return tuple(args[0].shape)


def least_seconds(calls):
    if not calls:
        return None
    total = 0.0
    for B, M, N in calls:
        nbytes = 4.0 * B * (M * N + 2 * M + 3 * N)
        total += bound_s(nbytes, 0.0, "f32")
    return total
