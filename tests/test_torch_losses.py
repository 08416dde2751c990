"""Port parity: the training losses. ``rpn_losses`` on identical inputs, and
the whole batch loss, its components and every parameter's gradient
against ``jax.value_and_grad`` of the JAX package's ``maskrcnn_loss``
(vmapped over the images and averaged, as its trainer does), on the same
weights, images, GT and sampling draws (f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.models import anchors as jax_anchors
from deepemia_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from deepemia_tpu.models.roi_align import roi_align_level as jax_roi_align_level
from deepemia_tpu.models.rpn import select_proposals as jax_select
from deepemia_tpu.train import losses as jax_losses
from deepemia_tpu.train import targets as jax_targets
from deepemia_tpu_torch.models import anchors as pt_anchors
from deepemia_tpu_torch.models.mask_rcnn import build_train_model
from deepemia_tpu_torch.models.rpn import select_proposals_batched
from deepemia_tpu_torch.models.weights import params_from_jax
from deepemia_tpu_torch.train import losses as pt_losses
from test_torch_heads import sane_geometry

torch.set_num_threads(2)

S, G = 64, 6
CAPS = dict(pre_nms_topk=128, post_nms_topk=64, rpn_batch=64, roi_batch=64, mask_rois=16)
COMPONENTS = ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")


def make_batch(seed, size=S, gmax=G):
    """Two images of bright disks on a noisy background with padded GT:
    boxes are the masks' tight bounds, classes alternate, some rows pad."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    img = (rng.random((2, size, size, 3)) * 50 + 40).astype(np.float32)
    boxes = np.zeros((2, gmax, 4), np.float32)
    classes = np.zeros((2, gmax), np.int32)
    valid = np.zeros((2, gmax), bool)
    masks = np.zeros((2, gmax, size, size), bool)
    for i, count in enumerate((4, 3)):
        for j in range(count):
            cx, cy = rng.uniform(10, size - 10, 2)
            r = rng.uniform(5, 12)
            m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            img[i][m] = 200.0
            ys, xs = np.nonzero(m)
            boxes[i, j] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            classes[i, j] = j % 2
            valid[i, j] = True
            masks[i, j] = m
    return img, jax_losses.GroundTruth(boxes=boxes, classes=classes, valid=valid, masks=masks)


def jax_draws(rng, n_anchors, n_rois):
    """The priorities the JAX trainer's key chain draws: one key per image,
    then (rpn, roi), then (positive, negative) each."""
    out = []
    for r in jax.random.split(rng, 2):
        per = []
        for key, n in zip(jax.random.split(r), (n_anchors, n_rois)):
            r_pos, r_neg = jax.random.split(key)
            per += [jax.random.uniform(r_pos, (n,)), jax.random.uniform(r_neg, (n,))]
        out.append(pt_losses.Draws(*(torch.from_numpy(np.array(d)) for d in per)))
    return out


def _pt_gt(gt):
    return pt_losses.GroundTruth(
        boxes=torch.from_numpy(gt.boxes), classes=torch.from_numpy(gt.classes).long(),
        valid=torch.from_numpy(gt.valid), masks=torch.from_numpy(gt.masks),
    )


@pytest.fixture(scope="module")
def parity(tiny_r50):
    """One JAX value_and_grad of the batch loss and one port loss +
    backward on the same weights, batch and draws."""
    model, params = tiny_r50
    params = sane_geometry(params)
    img, gt = make_batch(0)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        def per_image(im, boxes, classes, valid, masks, r):
            g = jax_losses.GroundTruth(boxes=boxes, classes=classes, valid=valid, masks=masks)
            return jax_losses.maskrcnn_loss(model, p, im, g, r, **CAPS)

        losses = jax.vmap(per_image)(
            jnp.asarray(img), *(jnp.asarray(x) for x in gt), jax.random.split(rng, 2)
        )
        means = jax.tree.map(jnp.mean, losses)
        return means["total"], means

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    port = build_train_model("R50", num_classes=2, device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params), 50), strict=True)
    n_anchors = sum(3 * (S // st) ** 2 for st in (4, 8, 16, 32, 64))
    draws = jax_draws(rng, n_anchors, CAPS["post_nms_topk"] + G)
    got = pt_losses.maskrcnn_loss(port, torch.from_numpy(img), _pt_gt(gt), draws=draws, **CAPS)
    got["total"].backward()
    got = {k: v.detach() for k, v in got.items()}
    return dict(
        model=model, params=params, img=img, gt=gt, port=port,
        ref={k: float(v) for k, v in ref.items()}, got={k: float(v) for k, v in got.items()},
        ref_grads=params_from_jax(jax.device_get(ref_grads), 50),
    )


def test_proposals_match_jax(parity):
    """Same proposals before any loss: a loss mismatch below is not a
    proposal flip."""
    model, params, img, port = parity["model"], parity["params"], parity["img"], parity["port"]
    with torch.no_grad():
        feats = port.features_batched(torch.from_numpy(img))
        logits, regs = port.rpn_forward(feats)
        anchors = pt_anchors.all_anchors({k: (v.shape[2], v.shape[3]) for k, v in feats.items()}, "cpu")
        got = select_proposals_batched(logits, regs, anchors, (S, S), CAPS["pre_nms_topk"], CAPS["post_nms_topk"])
    for i in range(2):
        f = model.apply(params, jnp.asarray(img[i]), method=JaxMaskRCNN.features)
        lg, rg = model.apply(params, f, method=JaxMaskRCNN.rpn_forward)
        shapes = {k: (v.shape[0], v.shape[1]) for k, v in f.items()}
        ref = jax_select(lg, rg, jax_anchors.all_anchors(shapes), (S, S), CAPS["pre_nms_topk"], CAPS["post_nms_topk"])
        v = np.asarray(ref.valid)
        assert v.sum() > 10
        np.testing.assert_array_equal(got.valid[i].numpy(), v)
        np.testing.assert_allclose(got.boxes[i].numpy()[v], np.asarray(ref.boxes)[v], atol=1e-3)


@pytest.mark.parametrize("name", COMPONENTS)
def test_loss_components_match_jax(parity, name):
    ref, got = parity["ref"][name], parity["got"][name]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=name)


def test_gradients_match_jax(parity):
    """Every parameter's gradient. Most tensors agree to 1e-4 of their
    largest entry (the median to ~3e-6): ~60 layers of f32 sums in another
    order. The tensors upstream of an isolated ReLU whose input sits within
    f32 noise of 0 (random weights put the trunk's activations at ~1e2)
    differ by up to ~3e-3 of their largest entry, so every tensor is held
    to 5e-3 of its largest entry and 80 % of them to 1e-4."""
    grads = {n: p.grad for n, p in parity["port"].named_parameters()}
    ref = parity["ref_grads"]
    assert set(grads) == set(ref)
    errs = []
    for name, r in ref.items():
        r = r.numpy()
        assert grads[name] is not None, name
        scale = float(np.abs(r).max())
        assert scale > 0, name
        err = float(np.abs(grads[name].numpy() - r).max()) / scale
        assert err <= 5e-3, (name, err)
        errs.append(err)
    assert np.mean(np.array(errs) <= 1e-4) >= 0.8, sorted(errs)[-10:]


def test_rpn_losses_match_jax():
    rng = np.random.default_rng(5)
    shapes = {"p2": (16, 16), "p3": (8, 8), "p4": (4, 4), "p5": (2, 2), "p6": (1, 1)}
    logits = {k: rng.standard_normal((h, w, 3)).astype(np.float32) for k, (h, w) in shapes.items()}
    regs = {k: (rng.standard_normal((h, w, 12)) * 0.3).astype(np.float32) for k, (h, w) in shapes.items()}
    _, gt = make_batch(1)
    key = jax.random.PRNGKey(3)
    ref = jax_losses.rpn_losses(
        {k: jnp.asarray(v) for k, v in logits.items()}, {k: jnp.asarray(v) for k, v in regs.items()},
        jax_anchors.all_anchors(shapes), jnp.asarray(gt.boxes[0]), jnp.asarray(gt.valid[0]), key, num_samples=64,
    )
    n = sum(3 * h * w for h, w in shapes.values())
    r_pos, r_neg = jax.random.split(key)
    got = pt_losses.rpn_losses(
        {k: torch.from_numpy(v) for k, v in logits.items()}, {k: torch.from_numpy(v) for k, v in regs.items()},
        pt_anchors.all_anchors(shapes, "cpu"), torch.from_numpy(gt.boxes[0]), torch.from_numpy(gt.valid[0]),
        num_samples=64, pos_rand=torch.from_numpy(np.array(jax.random.uniform(r_pos, (n,)))),
        neg_rand=torch.from_numpy(np.array(jax.random.uniform(r_neg, (n,)))),
    )
    for k in ("rpn_cls", "rpn_loc"):
        assert float(got[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_gt_mask_targets_match_jax():
    """The 28x28 mask targets of sampled RoIs: exactly the JAX crop's
    labels (matched GT mask, RoIAlign at stride 1, >= 0.5)."""
    img, gt = make_batch(2)
    rng = np.random.default_rng(2)
    boxes, gidx = [], []
    for i in range(2):
        n_valid = int(gt.valid[i].sum())
        pick = rng.integers(0, n_valid, 24)
        jitter = rng.uniform(-3, 3, (24, 4)).astype(np.float32)
        boxes.append(gt.boxes[i][pick] + np.where(np.arange(24)[:, None] % 3 == 0, 0.0, jitter))
        gidx.append(pick)
    boxes, gidx = np.stack(boxes).astype(np.float32), np.stack(gidx)
    got = pt_losses.gt_mask_targets(torch.from_numpy(gt.masks), torch.from_numpy(boxes), torch.from_numpy(gidx))
    for i in range(2):
        def crop(box, gi):
            m = jnp.asarray(gt.masks[i])[gi].astype(jnp.float32)[..., None]
            return jax_roi_align_level(m, box[None], stride=1, output_size=28)[0, :, :, 0] >= 0.5

        ref = np.asarray(jax.vmap(crop)(jnp.asarray(boxes[i]), jnp.asarray(gidx[i])))
        assert 0.05 < ref.mean() < 0.95
        np.testing.assert_array_equal(got[i].numpy(), ref)


def test_match_then_sample_reproduces_jax_roi_sample():
    """The RoI-stage sample of the loss (match against GT, subsample with
    the extra validity of proposals + GT) with the JAX draws."""
    _, gt = make_batch(3)
    rng = np.random.default_rng(3)
    props = np.concatenate([gt.boxes[0][:4] + rng.uniform(-4, 4, (4, 4)), rng.uniform(0, 60, (40, 4))])
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 2)
    props = np.concatenate([props, gt.boxes[0]]).astype(np.float32)
    valid = np.concatenate([rng.random(44) > 0.2, gt.valid[0]])
    key = jax.random.PRNGKey(11)
    m = jax_targets.match_proposals(jnp.asarray(props), jnp.asarray(gt.boxes[0]), jnp.asarray(gt.valid[0]))
    ref = jax_targets.subsample(m.labels, key, 32, 0.25, extra_valid=jnp.asarray(valid))
    r_pos, r_neg = jax.random.split(key)
    pm = pt_losses.T.match_proposals(torch.from_numpy(props), torch.from_numpy(gt.boxes[0]),
                                     torch.from_numpy(gt.valid[0]))
    got = pt_losses.T.subsample(
        pm.labels, 32, 0.25, extra_valid=torch.from_numpy(valid),
        pos_rand=torch.from_numpy(np.array(jax.random.uniform(r_pos, (len(props),)))),
        neg_rand=torch.from_numpy(np.array(jax.random.uniform(r_neg, (len(props),)))),
    )
    assert int(np.asarray(ref.is_pos & ref.valid).sum()) >= 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
