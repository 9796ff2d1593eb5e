"""stereo_vo_tpu_torch — the PyTorch + CUDA port of ``stereo_vo_tpu``.

The JAX package beside it stays the reference: each module here mirrors the
JAX module of the same path and name, and the ``tests/test_torch_*.py`` files
hold every ported function against its JAX counterpart on the same inputs.
This package imports ``torch`` and numpy, never ``jax`` or ``stereo_vo_tpu``.

- ``core``      geometry (quaternions/SE3), camera model, typed config
- ``ops``       filters, pyramids, Shi-Tomasi, region extraction (a CUDA
                kernel with its plain PyTorch version), pyramidal LK, sparse
                StereoBM
- ``frontend``  detect -> track -> PnP-RANSAC -> triangulate
- ``backend``   residuals + analytic Jacobians, window state, Schur-LM BA
- ``engine``    ``VOEngine`` bootstrap/step, the streaming ``run_vo`` driver,
                state conversion from the JAX package's leaves
- ``data``      ``StereoFrame`` and the synthetic stereo world (host, numpy)
- ``eval``      ATE and trajectory writers (host, numpy)
"""

__version__ = "0.1.0"

from stereo_vo_tpu_torch.core.camera import CameraInfo  # noqa: F401
from stereo_vo_tpu_torch.core.config import PipelineConfig, load_config  # noqa: F401
