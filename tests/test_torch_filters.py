"""Parity of the port's filters and pyramids with the JAX package.

Tolerance: the port writes every filter as the reference's shifted-add sum,
tap by tap in the same order, so results are equal to f32 rounding; the
bound is 1 ulp at the data's magnitude (rtol 2e-7 with a 1e-5 floor for
values near zero on 0-255 images).
"""

import numpy as np
import pytest

from stereo_vo_tpu.ops import filters as jf
from stereo_vo_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from stereo_vo_tpu.ops.pyramid import pyr_down as jax_pyr_down

from stereo_vo_tpu_torch.ops import filters as tf
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid, pyr_down

from torch_port_helpers import assert_close, to_jax, to_torch

ATOL, RTOL = 1e-5, 2e-7


def _image(rng, h=61, w=83, batch=()):
    return rng.uniform(0, 255, size=batch + (h, w)).astype(np.float32)


@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "scharr_x", "scharr_y"])
@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_derivative_filters(rng, name, mode):
    img = _image(rng, batch=(2,))
    want = getattr(jf, name)(to_jax(img), mode)
    got = getattr(tf, name)(to_torch(img), mode)
    assert_close(got, want, atol=ATOL, rtol=RTOL, what=f"{name}/{mode}")


def test_sep_filter_asymmetric_taps(rng):
    img = _image(rng)
    ky, kx = [0.25, -1.0, 0.0, 2.0, 0.5], [1.0, 0.0, -3.0]
    assert_close(tf.sep_filter(to_torch(img), ky, kx), jf.sep_filter(to_jax(img), ky, kx),
                 atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_box_filter_small_radius(rng, radius):
    img = _image(rng)
    assert_close(tf.box_filter(to_torch(img), radius), jf.box_filter(to_jax(img), radius),
                 atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("radius", [1, 2, 5, 9])
def test_max_filter(rng, radius):
    img = _image(rng, batch=(3,))
    img[0, 5, 7] = -np.inf
    assert_close(tf.max_filter(to_torch(img), radius), jf.max_filter(to_jax(img), radius),
                 atol=0)


def test_reflect_padding_matches_numpy(rng):
    img = _image(rng, h=5, w=4)
    got = tf.pad_2d(to_torch(img), 3, 2, mode="reflect")
    assert_close(got, np.pad(img, ((3, 3), (2, 2)), mode="reflect"), atol=0)
    got = tf.pad_2d(to_torch(img), 4, 6, mode="edge")
    assert_close(got, np.pad(img, ((4, 4), (6, 6)), mode="edge"), atol=0)


@pytest.mark.parametrize("shape", [(61, 83), (240, 320), (47, 155)])
def test_pyr_down(rng, shape):
    img = _image(rng, *shape)
    assert_close(pyr_down(to_torch(img)), jax_pyr_down(to_jax(img)), atol=ATOL, rtol=RTOL)


def test_build_pyramid(rng):
    img = rng.integers(0, 256, size=(120, 161)).astype(np.uint8)
    want = jax_build_pyramid(to_jax(img), 3)
    got = build_pyramid(to_torch(img), 3)
    assert len(got) == len(want) == 4
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, atol=ATOL, rtol=RTOL, what=f"level {lvl}")
