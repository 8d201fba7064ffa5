"""Model FLOPs shared by the configurations' counts: SuperPoint's
convolutions at an image's size."""

from reference.superpoint import LAYERS


def superpoint(h: int, w: int) -> float:
    """Multiply-adds x 2 of SuperPoint's convolutions on an (h, w) image:
    conv1 at full resolution, conv2 at 1/2, conv3 at 1/4, the rest at 1/8."""
    stride = {"1": 1, "2": 2, "3": 4}
    return sum(2.0 * (h // stride.get(name[4], 8)) * (w // stride.get(name[4], 8))
               * cin * cout * k * k for name, cin, cout, k in LAYERS)
