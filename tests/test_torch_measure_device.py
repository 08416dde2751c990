"""Port parity of the device measurement backend:
``measure_instances_device`` on a seeded ``InstanceSet`` against the JAX
package's, on the CPU in float32. The port measures each instance inside a
crop of its box; the JAX package pastes it over the whole image. Pixel
counts, areas, extents, perimeters and contrast percentiles must be equal,
the moments, axes and eccentricity within 1e-5 relative. The cases: a
blob, boxes past each image edge, a one-pixel mask, a box whose fade
reaches past it, ``valid`` False, a mask empty after the threshold, a thin
box and a box over the whole image."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepemia_tpu.inference import measure as jax_measure
from deepemia_tpu.inference.detections import InstanceSet as JaxInstanceSet
from deepemia_tpu_torch.inference import measure as pt_measure
from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.ops import morphometrics as pt_mm

torch.set_num_threads(2)

H, W = 70, 90
MOMENTS = ("major_axis", "minor_axis", "eccentricity", "centroid_x", "centroid_y")


def _instances(seed=0):
    rng = np.random.default_rng(seed)
    r = 28
    yy, xx = np.mgrid[0:r, 0:r] / (r - 1) - 0.5
    boxes, probs, valid = [], [], []

    def add(box, p, v=True):
        boxes.append(box)
        probs.append(p)
        valid.append(v)

    def blob():
        cx, cy, s = rng.uniform(-0.15, 0.15, 2).tolist() + [rng.uniform(0.08, 0.2)]
        p = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)) + rng.normal(0, 0.08, (r, r))
        return np.clip(p, 0, 1)

    add([10.3, 12.7, 40.1, 45.9], blob())
    add([-8.2, -5.5, 20.4, 18.1], blob())  # past the left and top edges
    add([70.6, 50.2, 101.3, 77.8], blob())  # past the right and bottom edges
    add([33.0, 20.0, 34.0, 21.0], np.ones((r, r)))  # one pixel
    add([19.8, 7.8, 76.2, 64.2], np.ones((r, r)))  # 2 px texels: below 0.5 the fade reaches past the box
    add([15.0, 30.0, 60.0, 60.0], blob(), False)  # not valid
    add([5.0, 5.0, 30.0, 30.0], np.zeros((r, r)))  # empty after the threshold
    add([2.5, 40.2, 88.7, 44.9], blob())  # thin
    add([0.0, 0.0, float(W), float(H)], blob())  # the whole image
    add([44.0, 33.0, 46.5, 35.5], blob())
    b = np.asarray(boxes, np.float32)
    p = np.asarray(probs, np.float32)
    v = np.asarray(valid, bool)
    k = len(b)
    return dict(boxes=b, scores=rng.random(k).astype(np.float32), classes=(np.arange(k) % 2).astype(np.int32),
                valid=v, mask_probs=p)


def _image(seed=1):
    return (np.random.default_rng(seed).random((H, W, 3)) * 255).astype(np.uint8)


def _assert_match(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].cpu().numpy(), np.asarray(ref[k])
        if k in MOMENTS:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("contrast, threshold", [(False, 0.5), (True, 0.5), (True, 0.3)])
@pytest.mark.parametrize("budget", [1, 3000, pt_measure.MEASURE_BUDGET])
def test_measure_instances_device_matches_jax(contrast, threshold, budget):
    d = _instances()
    img = _image()
    ref = jax_measure.measure_instances_device(
        JaxInstanceSet(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(img, jnp.float32),
        measure_contrast=contrast, mask_threshold=threshold,
    )
    inst = InstanceSet(**{k: torch.from_numpy(v) for k, v in d.items()})
    got = pt_measure.measure_instances_device(inst, torch.from_numpy(img), measure_contrast=contrast,
                                              mask_threshold=threshold, budget=budget)
    _assert_match(got, ref)
    assert not bool(got["valid"][5]) and not bool(got["valid"][6])  # not valid; empty
    assert float(got["pixel_count"][3]) == 1.0
    # below 0.5 the paste's fade reaches past the box
    n = float(got["pixel_count"][4])
    assert n == 56 * 56 if threshold == 0.5 else 56 * 56 < n < 58 * 58


def test_memory_follows_the_crops(monkeypatch):
    """On a 4096² image, small instances are measured in crops of their
    size, chunked under the budget: no tensor of the image's size."""
    d = _instances()
    d["boxes"] = d["boxes"][:4] * 0.5 + np.float32(2000.0)
    for k in ("scores", "classes", "valid", "mask_probs"):
        d[k] = d[k][:4]
    shapes = []
    real = pt_mm.measure_batch

    def spy(mask, *a, **kw):
        shapes.append(tuple(mask.shape))
        return real(mask, *a, **kw)

    monkeypatch.setattr(pt_mm, "measure_batch", spy)
    inst = InstanceSet(**{k: torch.from_numpy(v) for k, v in d.items()})
    img = torch.zeros((4096, 4096, 3), dtype=torch.uint8)
    budget = 1500
    got = pt_measure.measure_instances_device(inst, img, budget=budget)
    crops = pt_measure.measurement_crops(inst, (4096, 4096))
    assert shapes[0] == (1, 1, 1)  # the empty-mask values
    chunks = shapes[1:]
    assert sum(n for n, _, _ in chunks) == 4
    for n, h, w in chunks:
        assert n == 1 or n * h * w <= budget
        assert h <= int((crops[:, 3] - crops[:, 1]).max()) and w <= int((crops[:, 2] - crops[:, 0]).max())
    assert float(got["pixel_count"][3]) == 0.0 or bool(got["valid"][3])
