"""Op layer.

``sparse_dot_tpu.ops.device`` (module ``_xla``) holds the pure functional,
jit-compatible device kernels.
``sparse_dot_tpu.ops.host`` holds the eager host-boundary wrappers used by
the scipy-facing dispatch: numpy/scipy conversion, planar-complex
decomposition, ``out=`` accumulate semantics.
"""

from . import _xla as device
from . import host

__all__ = ["device", "host"]
