"""Region extraction: the port's plain version against the reference's CPU
path (``_extract_regions_vmap``, a vmapped ``dynamic_slice``) and against the
reference's two TPU kernels run in interpret mode (``_extract_regions_vmem``
and ``_extract_regions_tiled``, as ``tests/test_pallas_extract.py`` runs
them), and the CUDA kernel against the plain version on the card.

Tolerance: none. A region is a copy, so results must be bitwise equal, with
starts placed as ``dynamic_slice`` places them. The TPU kernels crop their
aligned bands with a one-hot f32 einsum, which on the CPU adds each pixel
times 1 to products that are all +0, an exact copy of the (nonzero) pixels.

The JAX package is imported inside the parity tests only, so that on a GPU
machine without JAX the kernel tests run alone:

    python -m pytest tests/test_torch_regions.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.ops.regions import extract_regions, extract_regions_ref, pad_edge

from torch_port_helpers import assert_equal, to_jax, to_torch

# (channels, Hp, Wp, ry, rx, n): the JAX package's extraction tests, the LK
# region sizes (56x56 inner levels, 88x88 top level) and the BM sizes
# (32x32 left window, 32x80 right search band) at their main-path widths;
# then a level over the 6 MiB where the JAX dispatcher takes its tiled
# variant, and the edges of the CUDA kernel's work split
# (csrc/extract_regions.cu): one feature, a last block of warps left partly
# empty, a partial last task (30 rows) with rx % 32 != 0, two channels, rows
# wider than one pass of a lane's four 32-column chunks
SHAPES = [
    (1, 384, 1256, 88, 88, 64),
    (1, 96, 320, 48, 48, 64),
    (1, 384, 1256, 32, 80, 32),
    (1, 420, 1285, 56, 56, 160),
    (1, 171, 384, 88, 88, 448),
    (1, 508, 1373, 32, 32, 320),
    (1, 508, 1373, 32, 80, 768),
    (2, 64, 96, 16, 24, 40),
    (1, 1280, 1280, 88, 88, 64),
    (1, 420, 1285, 56, 56, 1),
    (1, 420, 1285, 56, 56, 161),
    (1, 420, 1285, 30, 57, 33),
    (2, 232, 665, 56, 56, 160),
    (1, 420, 1285, 16, 160, 32),
]
# (variant, Hp, Wp, ry, rx, n) for the TPU kernels: the main path's region
# sizes at their padded levels (LK level 0, the hinted top level, the BM
# images), n a multiple of the kernels' 32-feature granule; the tiled
# variant also at the 1280x1280 level where the dispatcher picks it
TPU_SHAPES = [
    (variant, hp, wp, ry, rx, n)
    for variant in ("vmem", "tiled")
    for hp, wp, ry, rx, n in [(420, 1285, 56, 56, 32), (264, 697, 88, 88, 32),
                              (508, 1373, 32, 32, 64), (508, 1373, 32, 80, 64)]
] + [("tiled", 1280, 1280, 88, 88, 32)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, c, hp, wp, ry, rx, n, aligned=True):
    stack = (rng.normal(size=(c, hp, wp)) * 40 + 128).astype(np.float32)
    ox = rng.integers(0, wp - rx + 1, n)
    oy = rng.integers(0, hp - ry + 1, n)
    if aligned:
        ox, oy = ox // 8 * 8, oy // 8 * 8
    # both image corners, and origins the clamp has to pull back in
    edges = [(0, 0), (wp - rx, hp - ry), (-17, hp + 5), (wp + 40, -3)]
    for i, (x, y) in enumerate(edges[:n]):
        ox[i], oy[i] = x, y
    return stack, np.stack([ox, oy], 1).astype(np.int32)


def _aligned_inputs(rng, hp, wp, ry, rx, n):
    """The TPU kernels' contract: origins inside the image and 8-aligned in
    both axes, including both corners."""
    stack = (rng.normal(size=(1, hp, wp)) * 40 + 128).astype(np.float32)
    ox = rng.integers(0, wp - rx + 1, n) // 8 * 8
    oy = rng.integers(0, hp - ry + 1, n) // 8 * 8
    ox[0], oy[0] = 0, 0
    ox[1], oy[1] = (wp - rx) // 8 * 8, (hp - ry) // 8 * 8
    return stack, np.stack([ox, oy], 1).astype(np.int32)


@pytest.mark.parametrize("c,hp,wp,ry,rx,n", SHAPES)
def test_plain_extraction_matches_reference(rng, c, hp, wp, ry, rx, n):
    from stereo_vo_tpu.ops.pallas_extract import _extract_regions_vmap

    stack, origins = _inputs(rng, c, hp, wp, ry, rx, n, aligned=(c == 1))
    want = _extract_regions_vmap(to_jax(stack), to_jax(origins), ry, rx)
    got = extract_regions_ref(to_torch(stack), to_torch(origins), ry, rx)
    assert got.shape == (n, c, ry, rx)
    assert_equal(got, want)


@pytest.mark.parametrize("variant,hp,wp,ry,rx,n", TPU_SHAPES)
def test_plain_extraction_matches_tpu_kernels(rng, variant, hp, wp, ry, rx, n):
    from stereo_vo_tpu.ops.pallas_extract import (
        _FB,
        _extract_regions_tiled,
        _extract_regions_vmem,
    )

    assert n % _FB == 0
    kernel = {"vmem": _extract_regions_vmem, "tiled": _extract_regions_tiled}[variant]
    stack, origins = _aligned_inputs(rng, hp, wp, ry, rx, n)
    want = kernel(to_jax(stack)[0], to_jax(origins), ry, rx, interpret=True)
    got = extract_regions_ref(to_torch(stack), to_torch(origins), ry, rx)
    assert got.shape == (n, 1, ry, rx)
    assert_equal(got, want)


def test_cpu_wrapper_takes_the_plain_version(rng):
    stack, origins = _inputs(rng, 1, 96, 320, 48, 48, 32)
    before = extract_regions.launches
    got = extract_regions(to_torch(stack), to_torch(origins), 48, 48)
    assert extract_regions.launches == before       # no kernel launch on the CPU
    assert_equal(got, extract_regions_ref(to_torch(stack), to_torch(origins), 48, 48))


def test_rejects_regions_larger_than_the_image():
    with pytest.raises(ValueError):
        extract_regions(torch.zeros(1, 16, 16), torch.zeros(4, 2, dtype=torch.int32), 24, 8)


@pytest.mark.parametrize("m", [0, 3, 38])
def test_pad_edge_matches_reference(rng, m):
    from stereo_vo_tpu.ops.lk import _pad_edge as jax_pad_edge

    img = rng.normal(size=(1, 23, 37)).astype(np.float32)
    assert_equal(pad_edge(to_torch(img), m), jax_pad_edge(to_jax(img), m))


@pytest.mark.cuda
@pytest.mark.parametrize("c,hp,wp,ry,rx,n", SHAPES)
def test_cuda_kernel_matches_plain_version(rng, c, hp, wp, ry, rx, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    stack, origins = _inputs(rng, c, hp, wp, ry, rx, n)
    s = to_torch(stack).cuda()
    o = to_torch(origins).cuda()
    want = extract_regions_ref(s, o, ry, rx)
    # from a stack on a 16-byte boundary and from one 4 bytes past it
    for offset in (0, 1):
        flat = torch.empty(offset + s.numel(), device="cuda")
        s_off = flat[offset:].view(s.shape).copy_(s)
        before = extract_regions.launches
        got = extract_regions(s_off, o, ry, rx)
        torch.cuda.synchronize()
        assert extract_regions.launches == before + 1
        assert torch.equal(got, want), f"stack offset {offset}"
