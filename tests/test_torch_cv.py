"""The port's OpenCV replacements (``deepemia_tpu_torch/ops/cv.py``) equal
OpenCV bit for bit on seeded random uint8 images: odd and even sizes,
single rows and columns, noise, binary and blurred-binary content."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepemia_tpu_torch.ops import cv

SIZES = [(1, 1), (1, 9), (9, 1), (2, 2), (3, 5), (4, 8), (7, 13), (16, 31), (33, 64), (40, 101)]


def _image(rng, shape, kind):
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    binary = (rng.random(shape) < 0.4).astype(np.uint8) * 230
    return binary if kind == "binary" else cv2.GaussianBlur(binary, (3, 3), 0)


def _cases(seed, n_random=40, hi=90):
    rng = np.random.default_rng(seed)
    shapes = SIZES + [(int(rng.integers(1, hi)), int(rng.integers(1, hi))) for _ in range(n_random)]
    for i, shape in enumerate(shapes):
        yield _image(rng, shape, ("noise", "binary", "blur")[i % 3])


def test_bgr_to_gray_every_colour():
    v = np.arange(256, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    assert np.array_equal(cv.bgr_to_gray(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("seed", [0, 1])
def test_otsu(seed):
    rng = np.random.default_rng(seed)
    images = list(_cases(seed))
    # few-valued images have many equal between-class variances
    images += [rng.choice(rng.integers(0, 256, 3).astype(np.uint8), (17, 23)) for _ in range(40)]
    images += [np.full((5, 7), 9, np.uint8), np.zeros((1, 1), np.uint8)]
    for img in images:
        t_ref, b_ref = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        t, b = cv.otsu_threshold(img)
        assert t == t_ref and np.array_equal(b, b_ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_cubic_x2(seed):
    for img in _cases(seed, hi=160):
        ref = cv2.resize(img, None, fx=2, fy=2, interpolation=cv2.INTER_CUBIC)
        assert np.array_equal(cv.resize_cubic_x2(img), ref), img.shape


def test_resize_cubic_x2_few_valued_rows():
    """Few-valued rows produce exact .5 ties in the float and fixed-point
    columns alike, and short images take the fixed-point tail."""
    rng = np.random.default_rng(7)
    for _ in range(400):
        shape = (int(rng.integers(1, 9)), int(rng.integers(1, 70)))
        img = rng.choice(rng.integers(0, 256, 3).astype(np.uint8), shape)
        ref = cv2.resize(img, None, fx=2, fy=2, interpolation=cv2.INTER_CUBIC)
        assert np.array_equal(cv.resize_cubic_x2(img), ref), shape


@pytest.mark.parametrize("mode", ["down_integer", "down", "up", "mixed", "one_axis"])
def test_resize_area(mode):
    rng = np.random.default_rng(["down_integer", "down", "up", "mixed", "one_axis"].index(mode))
    for img in _cases(10, n_random=60, hi=70):
        h, w = img.shape
        if mode == "down_integer":
            fy, fx = int(rng.integers(1, 4)), int(rng.integers(1, 4))
            dh, dw = max(1, h // fy), max(1, w // fx)
            img = img[: dh * fy, : dw * fx]
        elif mode == "down":
            dh, dw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        elif mode == "up":
            dh, dw = int(rng.integers(h, 2 * h + 40)), int(rng.integers(w, 2 * w + 40))
        elif mode == "mixed":
            dh, dw = int(rng.integers(1, h + 1)), int(rng.integers(w, 2 * w + 40))
            if rng.random() < 0.5:
                dh, dw = int(rng.integers(h, 2 * h + 40)), int(rng.integers(1, w + 1))
        else:
            dh, dw = (h, int(rng.integers(1, 2 * w + 20))) if rng.random() < 0.5 else (int(rng.integers(1, 2 * h + 20)), w)
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
        assert np.array_equal(cv.resize_area(img, dw, dh), ref), (img.shape, (dh, dw))


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(
    st.integers(1, 40), st.integers(1, 40), st.integers(1, 60), st.integers(1, 60), st.integers(0, 2**31 - 1)
)
def test_resize_area_any_size(h, w, dh, dw, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
    assert np.array_equal(cv.resize_area(img, dw, dh), ref)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.6])
def test_connected_components_whole_stats_table(density):
    rng = np.random.default_rng(int(density * 100))
    shapes = SIZES + [(int(rng.integers(1, 120)), int(rng.integers(1, 120))) for _ in range(120)]
    for shape in shapes:
        img = ((rng.random(shape) < density) * 255).astype(np.uint8)
        n_ref, _, stats_ref, _ = cv2.connectedComponentsWithStats(img, 8)
        n, stats = cv.connected_components_with_stats(img)
        assert n == n_ref and np.array_equal(stats, stats_ref), shape
    for img in (np.full((3, 4), 255, np.uint8), np.zeros((3, 4), np.uint8)):
        n_ref, _, stats_ref, _ = cv2.connectedComponentsWithStats(img, 8)
        n, stats = cv.connected_components_with_stats(img)
        assert n == n_ref and np.array_equal(stats, stats_ref)


def test_gaussian_blur3():
    for img in _cases(3, n_random=60, hi=200):
        assert np.array_equal(cv.gaussian_blur3(img), cv2.GaussianBlur(img, (3, 3), 0)), img.shape


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_and_warp_affine(seed):
    rng = np.random.default_rng(seed)
    for img in _cases(20 + seed, n_random=80, hi=90):
        pad = int(rng.integers(0, 8))
        img = np.pad(img, pad)
        h, w = img.shape
        for angle in (float(rng.uniform(-10, 10)), float(rng.choice([-6.5, -0.05, 0.3, 4.1]))):
            m_ref = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0)
            m = cv.rotation_matrix2d((w / 2.0, h / 2.0), angle, 1.0)
            assert np.array_equal(m, m_ref)
            ref = cv2.warpAffine(img, m_ref, (w, h), flags=cv2.INTER_LINEAR)
            assert np.array_equal(cv.warp_affine_linear(img, m, (w, h)), ref), (img.shape, angle)
