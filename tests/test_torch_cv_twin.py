"""The port's OpenCV twin (``eval/cv_twin.py``) against the JAX package's on
the same frames. Both make the same OpenCV calls; only the rotation-matrix
to quaternion step differs (torch against JAX, f32), so poses agree within
1e-6.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo  # noqa: E402
from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig  # noqa: E402
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence  # noqa: E402
from stereo_vo_tpu.eval.cv_twin import run_cv_twin as jax_run_cv_twin  # noqa: E402

from stereo_vo_tpu_torch.core.config import FrontendConfig  # noqa: E402
from stereo_vo_tpu_torch.eval.cv_twin import run_cv_twin  # noqa: E402

from torch_port_helpers import port_camera  # noqa: E402


def test_cv_twin_matches_reference():
    jcam = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
    world = SyntheticStereoSequence(
        cam=jcam, n_frames=20, shape=(240, 320), n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0),
    )
    frames = list(world)
    kw = dict(min_distance=12.0, parallax_thresh=10.0)
    want, want_stats, _ = jax_run_cv_twin(frames, jcam, JFrontendConfig(**kw))
    got, got_stats, elapsed = run_cv_twin(frames, port_camera(jcam), FrontendConfig(**kw))
    assert got.shape == want.shape == (20, 7) and got.dtype == np.float32
    assert got_stats == want_stats
    assert sum(s["is_keyframe"] for s in got_stats) >= 3
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert elapsed > 0
    short, _, _ = run_cv_twin(frames, port_camera(jcam), FrontendConfig(**kw), max_frames=5)
    np.testing.assert_array_equal(short, got[:5])
