"""Port parity: the plain multilevel RoIAlign against the JAX package's
``multilevel_roi_align`` and its Pallas kernel (interpret mode), and the
CUDA wrapper's argument checks (through a stub library on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepemia_tpu.kernels.roi_align_pallas import LARGE_W, roi_align_pallas
from deepemia_tpu.models import roi_align as jax_ra
from deepemia_tpu_torch.kernels import roi_align as kra
from deepemia_tpu_torch.models import roi_align as pt_ra

torch.set_num_threads(2)

C = 32


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.default_rng(11)
    return {
        "p2": rng.standard_normal((128, 128, C)).astype(np.float32),
        "p3": rng.standard_normal((64, 64, C)).astype(np.float32),
        "p4": rng.standard_normal((32, 32, C)).astype(np.float32),
        "p5": rng.standard_normal((16, 16, C)).astype(np.float32),
    }


def _boxes(seed):
    """Random boxes on a 512² image plus the hard cases: off the edge,
    sub-pixel, p5-sized, degenerate, at the level boundary."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40, 520, (48, 2))
    wh = np.exp(rng.uniform(np.log(0.3), np.log(500), (48, 2)))
    rand = np.concatenate([xy, xy + wh], axis=1)
    special = np.array(
        [
            [-30.0, -20.0, 60.0, 50.0],  # off the top-left edge
            [480.0, 490.0, 540.0, 530.0],  # off the bottom-right edge
            [33.3, 21.7, 34.1, 22.2],  # sub-pixel
            [0.0, 0.0, 512.0, 512.0],  # p5, wider than 7 cells
            [10.0, 10.0, 400.0, 380.0],  # p4/p5
            [0.0, 0.0, 0.0, 0.0],  # padding row
            [100.0, 100.0, 212.0, 212.0],  # sqrt(area) = 112: level boundary
        ]
    )
    return np.concatenate([rand, special]).astype(np.float32)


def _pt(pyr):
    return {k: torch.from_numpy(v) for k, v in pyr.items()}


def _jx(pyr):
    return {k: jnp.asarray(v) for k, v in pyr.items()}


@pytest.mark.parametrize("out", [7, 14])
@pytest.mark.parametrize("adaptive", [True, False])
def test_plain_matches_jax_gather(pyramid, out, adaptive):
    boxes = _boxes(out + adaptive)
    ref = jax_ra.multilevel_roi_align(
        _jx(pyramid), jnp.asarray(boxes), output_size=out, adaptive_ratio=adaptive
    )
    got = pt_ra.multilevel_roi_align(
        _pt(pyramid), torch.from_numpy(boxes), output_size=out, adaptive_ratio=adaptive
    )
    assert got.shape == (len(boxes), out, out, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_valid_rows_and_zeros(pyramid):
    """Valid rows equal the JAX gather (which ignores ``valid``); invalid
    rows are exactly zero."""
    boxes = _boxes(5)
    valid = np.random.default_rng(5).random(len(boxes)) > 0.5
    ref = np.asarray(
        jax_ra.multilevel_roi_align(_jx(pyramid), jnp.asarray(boxes), 7, adaptive_ratio=True)
    )
    got = pt_ra.roi_align_dispatch(
        _pt(pyramid), torch.from_numpy(boxes), 7, adaptive_ratio=True,
        valid=torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5)
    assert (got[~valid] == 0.0).all()


def test_plain_batched_equals_single(pyramid):
    """A batch of pyramids with per-RoI image indices pools each RoI from
    its own image."""
    boxes = _boxes(6)
    pyr2 = {k: v * -0.5 for k, v in pyramid.items()}
    stacked = {k: torch.from_numpy(np.stack([pyramid[k], pyr2[k]])) for k in pyramid}
    bidx = torch.from_numpy((np.arange(len(boxes)) % 2).astype(np.int32))
    got = pt_ra.multilevel_roi_align(
        stacked, torch.from_numpy(boxes), 14, adaptive_ratio=True, batch_idx=bidx
    ).numpy()
    for img, pyr in enumerate((pyramid, pyr2)):
        rows = bidx.numpy() == img
        ref = pt_ra.multilevel_roi_align(
            _pt(pyr), torch.from_numpy(boxes[rows]), 14, adaptive_ratio=True
        ).numpy()
        np.testing.assert_allclose(got[rows], ref, atol=1e-6)


def _unbumped(boxes):
    """Rows the Pallas kernel pools at their sqrt-area level (it moves
    boxes longer than its window to a coarser level)."""
    lvl = np.asarray(jax_ra.assign_fpn_levels(jnp.asarray(boxes))) - 2
    max_px = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    fit = np.ceil(np.log2(np.maximum(max_px / (4.0 * (LARGE_W - 2)), 1e-6)))
    return fit <= lvl


@pytest.mark.parametrize("out", [7, 14])
def test_plain_matches_pallas_interpret(pyramid, out):
    boxes = _boxes(20 + out)[::3]
    valid = np.ones(len(boxes), bool)
    valid[::4] = False
    ref = np.asarray(
        roi_align_pallas(
            _jx(pyramid), jnp.asarray(boxes), output_size=out, adaptive_ratio=True,
            interpret=True, valid=jnp.asarray(valid),
        )
    )
    got = pt_ra.multilevel_roi_align(
        _pt(pyramid), torch.from_numpy(boxes), output_size=out, adaptive_ratio=True,
        valid=torch.from_numpy(valid),
    ).numpy()
    rows = valid & _unbumped(boxes)
    assert rows.sum() >= 5
    np.testing.assert_allclose(got[rows], ref[rows], atol=1e-4)
    assert (got[~valid] == 0.0).all() and (ref[~valid] == 0.0).all()


def test_assign_levels_match_jax():
    boxes = _boxes(9)
    np.testing.assert_array_equal(
        pt_ra.assign_fpn_levels(torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_ra.assign_fpn_levels(jnp.asarray(boxes))),
    )


class _StubKernel:
    """Stands in for the compiled library: records the call and returns the
    launch status it was given."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


def _wrapper_args(dtype=torch.float32, n=5):
    feats = [torch.zeros((2, s, s, 8), dtype=dtype) for s in (32, 16, 8, 4)]
    boxes = torch.zeros((n, 4))
    return feats, boxes, torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)


def test_wrapper_requires_cuda_tensors():
    feats, boxes, lv, bi = _wrapper_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kra.roi_align_cuda(feats, boxes, lv, bi, None)


@pytest.mark.parametrize(
    "mutate, message",
    [
        (lambda a: a.__setitem__(0, [f.permute(0, 3, 1, 2).contiguous() for f in a[0]]), r"\[B,H,W,C\]"),
        (lambda a: a.__setitem__(0, [f.transpose(1, 2) for f in a[0]]), "NHWC-contiguous"),
        (lambda a: a.__setitem__(0, [f.half() for f in a[0]]), "float32 or bfloat16"),
        (lambda a: a.__setitem__(1, a[1].double()), "boxes"),
        (lambda a: a.__setitem__(2, a[2].long()), "levels"),
        (lambda a: a.__setitem__(3, a[3][:2]), "batch_idx"),
        (lambda a: a.__setitem__(0, a[0][:3]), "4 levels"),
    ],
)
def test_wrapper_refuses_misuse(monkeypatch, mutate, message):
    stub = _StubKernel()
    monkeypatch.setattr(kra, "_require_cuda", lambda tensors: None)
    monkeypatch.setattr(kra, "_library", lambda: stub)
    args = list(_wrapper_args())
    mutate(args)
    with pytest.raises(ValueError, match=message):
        kra.roi_align_cuda(*args, None)
    assert not stub.calls


def test_wrapper_launch_counts_and_status(monkeypatch):
    stub = _StubKernel()
    monkeypatch.setattr(kra, "_require_cuda", lambda tensors: None)
    monkeypatch.setattr(kra, "_library", lambda: stub)
    monkeypatch.setattr(kra.torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = kra.counter.launches
    feats, boxes, lv, bi = _wrapper_args(torch.bfloat16)
    out = kra.roi_align_cuda(feats, boxes, lv, bi, torch.ones(5, dtype=torch.bool),
                             output_size=14, out_dtype=torch.bfloat16)
    assert out.shape == (5, 14, 14, 8) and out.dtype == torch.bfloat16
    assert kra.counter.launches == before + 1 and len(stub.calls) == 1
    args = stub.calls[0]
    assert args[:4] == tuple(f.data_ptr() for f in feats)
    assert args[4:12] == (32, 32, 16, 16, 8, 8, 4, 4)
    assert args[12] == boxes.data_ptr() and args[16] == out.data_ptr()
    assert args[-8:-1] == (5, 8, 14, 2, 0, 1, 1)
    stub.status = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kra.roi_align_cuda(feats, boxes, lv, bi, None)
    assert kra.counter.launches == before + 1
