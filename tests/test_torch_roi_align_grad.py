"""Port parity: the RoIAlign backward. The plain adjoint (kernel K2's plain
version, reached through ``RoIAlignFunction`` on the CPU) against
``jax.grad`` of the JAX package's ``multilevel_roi_align_fast_grad`` and
against its Pallas backward kernel in interpret mode; ``gradcheck`` in
float64; the GT-mask crop ``roi_align_level``; and the K2 wrapper's checks
(through a stub library on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.kernels.roi_align_pallas import LARGE_W, roi_align_backward_pallas
from deepemia_tpu.models import roi_align as jax_ra
from deepemia_tpu_torch.kernels import roi_align as kra
from deepemia_tpu_torch.models import roi_align as pt_ra

torch.set_num_threads(2)

C = 16
LEVELS = ("p2", "p3", "p4", "p5")


def _pyramid(seed, bsz=None):
    rng = np.random.default_rng(seed)
    lead = () if bsz is None else (bsz,)
    return {
        nm: rng.standard_normal((*lead, s, s, C)).astype(np.float32)
        for nm, s in zip(LEVELS, (128, 64, 32, 16))
    }


def _boxes(seed):
    """Random boxes on a 512² image plus the hard cases: off the edge,
    sub-pixel, p5-sized, degenerate, at the level boundary."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40, 520, (40, 2))
    wh = np.exp(rng.uniform(np.log(0.3), np.log(500), (40, 2)))
    special = np.array(
        [
            [-30.0, -20.0, 60.0, 50.0],  # off the top-left edge
            [480.0, 490.0, 540.0, 530.0],  # off the bottom-right edge
            [33.3, 21.7, 34.1, 22.2],  # sub-pixel
            [0.0, 0.0, 512.0, 512.0],  # p5, wider than 7 cells
            [10.0, 10.0, 400.0, 380.0],  # p4/p5
            [0.0, 0.0, 0.0, 0.0],  # degenerate row
            [100.0, 100.0, 212.0, 212.0],  # sqrt(area) = 112: level boundary
        ]
    )
    return np.concatenate([np.concatenate([xy, xy + wh], 1), special]).astype(np.float32)


def _cotangent(seed, n, out):
    return np.random.default_rng(seed).standard_normal((n, out, out, C)).astype(np.float32)


def _port_grad(pyr, boxes, g, out, adaptive, batch_idx=None):
    feats = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pyr.items()}
    pooled = pt_ra.roi_align_dispatch(
        feats, torch.from_numpy(boxes), out, adaptive_ratio=adaptive,
        batch_idx=None if batch_idx is None else torch.from_numpy(batch_idx),
    )
    (pooled * torch.from_numpy(g)).sum().backward()
    return pooled.detach().numpy(), {k: v.grad.numpy() for k, v in feats.items()}


def _assert_grads_close(got, ref, rel=1e-5):
    for k in LEVELS:
        a = np.asarray(ref[k])
        tol = rel * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(got[k], a, atol=tol, err_msg=k)


@pytest.mark.parametrize("out", [7, 14])
@pytest.mark.parametrize("adaptive", [True, False])
def test_plain_backward_matches_jax_fast_grad(out, adaptive):
    pyr = _pyramid(1)
    boxes = _boxes(out + adaptive)
    g = _cotangent(2, len(boxes), out)

    def loss(f):
        pooled = jax_ra.multilevel_roi_align_fast_grad(
            f, jnp.asarray(boxes), output_size=out, adaptive_ratio=adaptive, fwd_backend="xla"
        )
        return (pooled * jnp.asarray(g)).sum()

    ref = jax.grad(loss)({k: jnp.asarray(v) for k, v in pyr.items()})
    pooled, got = _port_grad(pyr, boxes, g, out, adaptive)
    assert pooled.shape == (len(boxes), out, out, C)
    _assert_grads_close(got, ref)
    assert all(np.abs(got[k]).max() > 0 for k in LEVELS)


def test_plain_backward_batched_matches_vmapped_jax():
    """Two images in one call with per-RoI image indices: each image's
    gradient equals the JAX gradient of its own RoIs (vmapped)."""
    pyr = _pyramid(4, bsz=2)
    boxes = np.stack([_boxes(5), _boxes(6)])  # [2,K,4]
    k = boxes.shape[1]
    g = _cotangent(7, 2 * k, 14).reshape(2, k, 14, 14, C)

    def loss(f):
        def one(fl, bx, gi):
            pooled = jax_ra.multilevel_roi_align_fast_grad(
                fl, bx, output_size=14, adaptive_ratio=True, fwd_backend="xla"
            )
            return (pooled * gi).sum()

        return jax.vmap(one)(f, jnp.asarray(boxes), jnp.asarray(g)).sum()

    ref = jax.grad(loss)({nm: jnp.asarray(v) for nm, v in pyr.items()})
    bidx = np.repeat(np.arange(2, dtype=np.int32), k)
    _, got = _port_grad(pyr, boxes.reshape(-1, 4), g.reshape(-1, 14, 14, C), 14, True, bidx)
    _assert_grads_close(got, ref)


def _unbumped(boxes):
    """Rows the Pallas kernels pool at their sqrt-area level (they move
    boxes longer than their window to a coarser level)."""
    lvl = np.asarray(jax_ra.assign_fpn_levels(jnp.asarray(boxes))) - 2
    max_px = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    fit = np.ceil(np.log2(np.maximum(max_px / (4.0 * (LARGE_W - 2)), 1e-6)))
    return fit <= lvl


def test_plain_backward_matches_pallas_interpret():
    """The plain adjoint against the Pallas backward kernel (interpret
    mode) on the boxes that kernel does not move to a coarser level."""
    pyr = _pyramid(8)
    boxes = _boxes(9)[::4]
    boxes = boxes[_unbumped(boxes)]
    assert len(boxes) >= 8
    g = _cotangent(10, len(boxes), 7)
    ref = roi_align_backward_pallas(
        jnp.asarray(g), jnp.asarray(boxes), [v.shape[:2] for v in pyr.values()],
        output_size=7, adaptive_ratio=True, interpret=True,
    )
    _, got = _port_grad(pyr, boxes, g, 7, True)
    _assert_grads_close(got, ref, rel=1e-4)


def test_function_gradcheck_float64():
    """The forward is linear in the features and the backward its exact
    adjoint: gradcheck holds in float64 (sums in float64 too)."""
    rng = np.random.default_rng(12)
    feats = [
        torch.from_numpy(rng.standard_normal((2, s, s, 2))).requires_grad_(True)
        for s in (16, 8, 4, 2)
    ]
    boxes = torch.tensor(
        [[3.0, 5.0, 30.0, 21.0], [-4.0, 1.5, 9.2, 12.0], [0.0, 0.0, 64.0, 64.0], [20.2, 30.1, 21.0, 30.9]]
    )
    bidx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)

    def fn(*f):
        return pt_ra.RoIAlignFunction.apply(boxes, bidx, None, 3, 2, True, None, *f)

    assert fn(*feats).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, feats, eps=1e-6, atol=1e-8)


def test_function_forward_equals_plain_and_box_grad_is_none():
    pyr = _pyramid(13)
    boxes = torch.from_numpy(_boxes(14)).requires_grad_(True)
    feats = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pyr.items()}
    out = pt_ra.roi_align_dispatch(feats, boxes, 7, adaptive_ratio=True)
    ref = pt_ra.multilevel_roi_align({k: torch.from_numpy(v) for k, v in pyr.items()}, boxes.detach(), 7,
                                     adaptive_ratio=True)
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert boxes.grad is None and feats["p2"].grad is not None


def test_function_invalid_rows_get_no_gradient():
    """With a ``valid`` mask the cotangent of invalid rows is dropped: the
    feature gradient equals the one of the valid rows alone, and the
    invalid rows of the forward are zeros."""
    pyr = _pyramid(15, bsz=2)
    boxes = _boxes(16)
    n = len(boxes)
    valid = np.random.default_rng(17).random(n) > 0.4
    bidx = (np.arange(n) % 2).astype(np.int32)
    g = _cotangent(18, n, 14)
    feats = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pyr.items()}
    pooled = pt_ra.roi_align_dispatch(
        feats, torch.from_numpy(boxes), 14, adaptive_ratio=True, valid=torch.from_numpy(valid),
        batch_idx=torch.from_numpy(bidx),
    )
    assert (pooled.detach().numpy()[~valid] == 0.0).all()
    (pooled * torch.from_numpy(g)).sum().backward()
    _, ref = _port_grad(pyr, boxes[valid], g[valid], 14, True, bidx[valid])
    _assert_grads_close({k: v.grad.numpy() for k, v in feats.items()}, ref, rel=1e-6)
    assert all(np.abs(ref[k]).max() > 0 for k in LEVELS)


def test_plain_backward_adds_coincident_corners():
    """On a level one cell tall every sample clamps both row corners onto
    row 0: both weights land there, so the level receives the full
    cotangent mass."""
    feats = [torch.zeros(1, h, 8, 2) for h in (1, 1, 1, 1)]
    boxes = torch.tensor([[0.0, 0.0, 16.0, 4.0]])  # p2, 4x1 cells: y in [-0.375, 0.375]
    g = torch.ones(1, 2, 2, 2)
    grads = pt_ra.multilevel_roi_align_backward(g, boxes, [tuple(f.shape[:3]) for f in feats])
    # every sample is valid; each spreads weight 1 over its corners
    np.testing.assert_allclose(float(grads[0].sum()), float(g.sum()), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_align_level_matches_jax(seed):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((40, 48, 3)).astype(np.float32)
    boxes = _boxes(seed)[:30] / 10.0
    ref = jax_ra.roi_align_level(jnp.asarray(feat), jnp.asarray(boxes), stride=1, output_size=14)
    got = pt_ra.roi_align_level(torch.from_numpy(feat), torch.from_numpy(boxes), stride=1, output_size=14)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # strided, batched form
    stack = np.stack([feat, -feat])
    bidx = (np.arange(len(boxes)) % 2).astype(np.int64)
    got_b = pt_ra.roi_align_level(torch.from_numpy(stack), torch.from_numpy(boxes * 4), stride=4,
                                  output_size=7, batch_idx=torch.from_numpy(bidx))
    for img in (0, 1):
        rows = bidx == img
        ref_b = jax_ra.roi_align_level(jnp.asarray(stack[img]), jnp.asarray(boxes[rows] * 4), stride=4, output_size=7)
        np.testing.assert_allclose(got_b.numpy()[rows], np.asarray(ref_b), atol=1e-6)


def test_roi_align_level_mask_labels_match_jax():
    """0/1 masks sampled on pixel-aligned and fractional boxes land on
    exactly 0.5 at edges: the >= 0.5 labels agree exactly."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:64, :64]
    masks = np.stack([(xx - 20) ** 2 + (yy - 30) ** 2 <= 144, (xx > 33) & (yy > 10) & (yy < 50)])
    boxes = np.concatenate(
        [np.array([[8, 18, 33, 43], [33, 10, 64, 50], [0, 0, 64, 64]], np.float32),
         np.concatenate([rng.uniform(0, 40, (20, 2)), rng.uniform(0, 40, (20, 2)) + 24], 1).astype(np.float32),
         np.round(rng.uniform(0, 64, (20, 4)) * 2).astype(np.float32) / 2]
    )
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    idx = np.arange(len(boxes)) % 2
    ref = jax.vmap(
        lambda b, i: jax_ra.roi_align_level(jnp.asarray(masks, jnp.float32)[i][..., None], b[None], stride=1,
                                            output_size=28)[0, :, :, 0] >= 0.5
    )(jnp.asarray(boxes), jnp.asarray(idx))
    got = pt_ra.roi_align_level(torch.from_numpy(masks)[..., None], torch.from_numpy(boxes), stride=1,
                                output_size=28, batch_idx=torch.from_numpy(idx))[..., 0] >= 0.5
    ref = np.asarray(ref)
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(got.numpy(), ref)


class _StubKernel:
    """Stands in for the compiled library: records the call and returns the
    launch status it was given."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


def _bwd_args(dtype=torch.float32, n=5, out=7):
    g = torch.zeros((n, out, out, 8), dtype=dtype)
    boxes = torch.zeros((n, 4))
    shapes = [(2, s, s) for s in (32, 16, 8, 4)]
    return [g, boxes, torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), shapes]


def test_bwd_wrapper_requires_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kra.roi_align_backward_cuda(*_bwd_args())


@pytest.mark.parametrize(
    "mutate, message",
    [
        (lambda a: a.__setitem__(0, a[0].half()), "float32 or bfloat16"),
        (lambda a: a.__setitem__(0, a[0].transpose(1, 2)), r"contiguous \[N,out,out,C\]"),
        (lambda a: a.__setitem__(0, a[0][:3]), r"contiguous \[N,out,out,C\]"),
        (lambda a: a.__setitem__(0, a[0][..., :7].contiguous()), "multiple of 8"),
        (lambda a: a.__setitem__(0, torch.zeros(a[0].numel() + 1)[1:].view(a[0].shape)), "16-byte aligned"),
        (lambda a: a.__setitem__(0, torch.zeros(5, 33, 33, 8)), r"output_size \* sampling_ratio = 66"),
        (lambda a: a.__setitem__(1, a[1].double()), "boxes"),
        (lambda a: a.__setitem__(2, a[2].long()), "levels"),
        (lambda a: a.__setitem__(3, a[3][:2]), "batch_idx"),
        (lambda a: a.__setitem__(4, a[4][:3]), "level_shapes"),
    ],
)
def test_bwd_wrapper_refuses_misuse(monkeypatch, mutate, message):
    stub = _StubKernel()
    monkeypatch.setattr(kra, "_require_cuda", lambda tensors: None)
    monkeypatch.setattr(kra, "_bwd_library", lambda: stub)
    args = _bwd_args()
    mutate(args)
    with pytest.raises(ValueError, match=message):
        kra.roi_align_backward_cuda(*args)
    assert not stub.calls


def test_bwd_wrapper_launch_counts_and_status(monkeypatch):
    stub = _StubKernel()
    monkeypatch.setattr(kra, "_require_cuda", lambda tensors: None)
    monkeypatch.setattr(kra, "_bwd_library", lambda: stub)
    monkeypatch.setattr(kra.torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = kra.bwd_counter.launches
    g, boxes, lv, bi, shapes = _bwd_args(torch.bfloat16, out=14)
    grads = kra.roi_align_backward_cuda(g, boxes, lv, bi, shapes, adaptive_ratio=True, out_dtype=torch.bfloat16)
    assert [tuple(t.shape) for t in grads] == [(2, s, s, 8) for s in (32, 16, 8, 4)]
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in grads)
    assert kra.bwd_counter.launches == before + 1 and len(stub.calls) == 1
    args = stub.calls[0]
    assert args[0] == g.data_ptr() and args[1] == boxes.data_ptr()
    assert args[5] == grads[0].data_ptr() and args[4] != args[5]  # f32 accumulators, bf16 output
    assert args[6:15] == (2, 32, 32, 16, 16, 8, 8, 4, 4)
    assert args[15:22] == (5, 8, 14, 2, 1, 1, 1)
    # float32 output is the accumulator buffer itself
    kra.roi_align_backward_cuda(g.float(), boxes, lv, bi, shapes)
    assert stub.calls[1][4] == stub.calls[1][5]
    stub.status = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kra.roi_align_backward_cuda(g, boxes, lv, bi, shapes)
    assert kra.bwd_counter.launches == before + 2
