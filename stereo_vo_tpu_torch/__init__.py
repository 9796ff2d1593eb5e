"""stereo_vo_tpu_torch — the PyTorch + CUDA port of ``stereo_vo_tpu``.

The JAX package beside it stays the reference: each module here mirrors the
JAX module of the same path and name, and the ``tests/test_torch_*.py`` files
hold every ported function against its JAX counterpart on the same inputs.
This package imports ``torch`` and numpy, never ``jax`` or ``stereo_vo_tpu``.

- ``core``      geometry (quaternions/SE3), camera model, typed config
- ``ops``       filters, pyramids, Shi-Tomasi (greedy and maxpool NMS),
                region extraction (a CUDA kernel with its plain PyTorch
                version), pyramidal LK (forward-backward and forward only),
                StereoBM (sparse and dense)
- ``frontend``  detect -> track -> PnP-RANSAC -> triangulate
- ``backend``   residuals + analytic Jacobians, window state, Schur-LM BA
                (f32 LU + refinement or the f64 island, condition probe)
- ``parallel``  the landmark-sharded BA on ``torch.distributed``, meshes,
                process bootstrap, a local rank launcher and the dry run
- ``engine``    ``VOEngine`` bootstrap/step/replay_chunk, the ``run_vo``
                driver (streaming and chunked replay with device preload),
                checkpoint/resume, JSONL metrics, state conversion from the
                JAX package's leaves
- ``data``      ``StereoFrame``, ``LiveStereoStream``, the synthetic stereo
                world, the KITTI loader and the native PNG decoder (host)
- ``eval``      ATE, trajectory I/O, track drawing and plots, the OpenCV twin (host)
- ``utils``     stage timers and ``torch.profiler`` traces
- ``cli``, ``smoke``  the ``svo-torch`` command and the device smoke gate
"""

__version__ = "0.1.0"

from stereo_vo_tpu_torch.core.camera import CameraInfo  # noqa: F401
from stereo_vo_tpu_torch.core.config import PipelineConfig, load_config  # noqa: F401
