"""The committed glyph atlas of the port's scale-bar reader is current: a
few heights regenerated here with ``tools/make_torch_glyph_atlas.py`` (the
JAX package's renderer, OpenCV and PIL) equal the committed arrays byte for
byte, and the reader loads them in the JAX package's template order."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from deepemia_tpu.inference import scalebar as ref_sb
from deepemia_tpu_torch.inference import scalebar as sb

ROOT = Path(__file__).resolve().parents[1]
HEIGHTS = [8, 9, 23, 56, 97, 128]


def _generator():
    spec = importlib.util.spec_from_file_location("make_torch_glyph_atlas", ROOT / "tools" / "make_torch_glyph_atlas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def committed():
    with np.load(ROOT / "deepemia_tpu_torch" / "inference" / "glyph_atlas.npz") as z:
        return {k: z[k] for k in z.files}


def _templates_of(arrays, height):
    i = int(np.nonzero(arrays["heights"] == height)[0][0])
    per = len(arrays["glyphs"]) // len(arrays["heights"])
    out = []
    for j in range(i * per, (i + 1) * per):
        px = arrays["pixels"][arrays["offsets"][j] : arrays["offsets"][j + 1]]
        out.append((int(arrays["glyphs"][j]), tuple(arrays["shapes"][j]), px.tobytes()))
    return out


def test_committed_atlas_covers_its_range(committed):
    gen = _generator()
    lo, hi = sb.atlas_heights()
    assert (lo, hi) == (gen.MIN_HEIGHT, gen.MAX_HEIGHT)
    assert committed["heights"].tolist() == list(range(lo, hi + 1))
    assert len(committed["glyphs"]) == gen.TEMPLATES_PER_HEIGHT * (hi - lo + 1)
    assert bytes(committed["glyph_set"]).decode("utf-8") == ref_sb.GLYPHS


@pytest.mark.parametrize("height", HEIGHTS)
def test_regenerated_heights_equal_the_committed_atlas(committed, height):
    fresh = _generator().build([height])
    assert _templates_of(fresh, height) == _templates_of(committed, height)


@pytest.mark.parametrize("height", [8, 40, 128])
def test_reader_templates_are_the_reference_templates(height):
    ref = ref_sb._glyph_templates(height, 0.0)
    got = sb._atlas()[height]
    assert [ch for ch, _ in got] == [ch for ch, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rotated_templates_equal_the_reference():
    """The port rotates the atlas with its own warp; the JAX package with
    OpenCV's. Same key rounding, same pixels."""
    for height, angle in ((24, -4.13), (24, -4.14), (40, 6.5)):
        ref_sb._TEMPLATE_CACHE.clear()
        sb._TEMPLATE_CACHE.clear()
        ref = ref_sb._glyph_templates(height, angle)
        got = sb._glyph_templates(height, angle)
        assert len(got) == len(ref)
        for (c1, a), (c2, b) in zip(got, ref):
            assert c1 == c2 and np.array_equal(a, b)
        assert list(sb._TEMPLATE_CACHE) == list(ref_sb._TEMPLATE_CACHE)
    ref_sb._TEMPLATE_CACHE.clear()
    sb._TEMPLATE_CACHE.clear()
