"""Native incremental Structure-from-Motion.

Port of the JAX package's ``sfm/``. The reference delegates SfM to pycolmap
(reference ``reconstruction.py:12-110``, C++ COLMAP on the host). This
package provides a standalone incremental mapper so reconstruction works
without pycolmap: two-view initialization, batched DLT triangulation, RANSAC
PnP registration (float64 numpy and OpenCV on the host), and
Levenberg-Marquardt bundle adjustment in PyTorch on the mapper's device
(``ba.py``: matrix-free normal equations + Jacobi-preconditioned CG), while
the mapper loop stays on the host.

When pycolmap *is* installed it remains the default backend (full COLMAP
fidelity); select this mapper with ``general.sfm_backend: native`` or let
``reconstruction.incremental_reconstruction`` fall back to it automatically.
"""

from .incremental import IncrementalMapper, native_incremental_mapping  # noqa: F401
