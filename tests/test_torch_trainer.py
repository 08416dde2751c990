"""Port parity: the trainer. The schedule, one optimizer update against the
JAX package's optax chain, the fine-tune freeze mask, the from-scratch
conditioning, the mask bit unpacking, and a short CPU ``train_on_batches()`` with a
checkpoint and a resume (the port's analogue of tests/test_train_loop.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepemia_tpu.train import trainer as jax_tr
from deepemia_tpu_torch.models.mask_rcnn import build_train_model
from deepemia_tpu_torch.models.weights import params_from_jax
from deepemia_tpu_torch.train import trainer as pt_tr
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)


@pytest.mark.parametrize("max_iter, warmup", [(1000, 100), (5000, 1000), (3, 2), (50, 0)])
def test_schedule_matches_jax(max_iter, warmup):
    ref = jax_tr.warmup_multistep_schedule(0.02, max_iter, warmup, gamma=0.1)
    got = pt_tr.warmup_multistep_schedule(0.02, max_iter, warmup, gamma=0.1)
    counts = sorted(set(np.linspace(0, max_iter + 5, 97).astype(int)) | {0, 1, warmup, int(0.6 * max_iter),
                                                                     int(0.8 * max_iter)})
    for c in counts:
        np.testing.assert_allclose(got(c), float(ref(jnp.int32(c))), rtol=1e-6, err_msg=str(c))


def test_auto_max_iter_matches_jax():
    for n in (1, 4, 5, 99, 100, 250, 3000):
        assert pt_tr.auto_max_iter(n) == jax_tr.auto_max_iter(n)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_steps_match_optax(clip):
    """Three updates on the same gradients: the clip -> weight decay ->
    momentum SGD chain with the schedule read from count 0."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.7).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    kw = dict(base_lr=0.1, max_iter=3, warmup_iters=2, gamma=0.1)

    tx = jax_tr.make_optimizer(kw["base_lr"], kw["max_iter"], kw["warmup_iters"], kw["gamma"], grad_clip_norm=clip)
    p_ref = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p_ref)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)

    p_got = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = pt_tr.make_optimizer(list(p_got.values()), **kw)
    for g in grads:
        for k, p in p_got.items():
            p.grad = torch.from_numpy(g[k])
        pt_tr.optimizer_step(opt, sched, clip)
    for k in shapes:
        np.testing.assert_allclose(p_got[k].detach().numpy(), np.asarray(p_ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.allclose(p_got[k].detach().numpy(), params[k])


def test_trainable_mask_matches_jax(tiny_r50):
    _, params = tiny_r50
    flags = jax_tr._trainable_mask(params)
    as_arrays = jax.tree.map(lambda p, f: np.full(p.shape, float(f), np.float32), params, flags)
    ref = {k: bool(v.flatten()[0]) for k, v in params_from_jax(as_arrays, 50).items()}
    got = pt_tr._trainable_mask(build_train_model("R50", 2, device="cpu"))
    assert got == ref
    assert 0 < sum(got.values()) < len(got)


def test_zero_residual_norms_matches_jax(tiny_r50):
    _, params = tiny_r50
    ref = params_from_jax(jax.device_get(jax_tr.zero_residual_norms(params)), 50)
    before = params_from_jax(jax.device_get(params), 50)
    model = build_train_model("R50", 2, device="cpu")
    model.load_state_dict(before)
    pt_tr.zero_residual_norms(model)
    got = model.state_dict()
    changed = 0
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
        changed += not torch.equal(v, before[k])
    assert changed == 16 + 1  # every bottleneck's last norm scale + the stem norm


def test_unpack_mask_bits_matches_jax():
    bits = np.random.default_rng(1).random((2, 3, 16, 24)) > 0.5
    packed = np.packbits(bits, axis=-1)
    ref = np.asarray(jax_tr.unpack_mask_bits(jnp.asarray(packed)))
    got = pt_tr.unpack_mask_bits(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, bits)


S = 64
CFG = dict(
    train_size=S, max_instances=8, use_bf16=False, warmup_iters=2, log_every=1,
    loss_caps=dict(pre_nms_topk=128, post_nms_topk=64, rpn_batch=64, roi_batch=64, mask_rois=16),
)


def loader_batches(n, seed=0, gmax=8):
    """Batches in the loader's format: uint8 images of bright disks,
    padded GT, bit-packed masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S]
    out = []
    for _ in range(n):
        img = (rng.random((2, S, S, 3)) * 50 + 40).astype(np.uint8)
        boxes = np.zeros((2, gmax, 4), np.float32)
        valid = np.zeros((2, gmax), bool)
        masks = np.zeros((2, gmax, S, S), bool)
        for i in range(2):
            for j in range(3):
                cx, cy, r = rng.uniform(12, S - 12), rng.uniform(12, S - 12), rng.uniform(5, 10)
                m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
                img[i][m] = 210
                ys, xs = np.nonzero(m)
                boxes[i, j] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                valid[i, j] = True
                masks[i, j] = m
        out.append(dict(image=img, gt_boxes=boxes, gt_classes=np.zeros((2, gmax), np.int32), gt_valid=valid,
                        gt_masks=np.packbits(masks, axis=-1)))
    return out


def _weights(path):
    return torch.load(path, map_location="cpu")["model"]


def test_train_checkpoint_resume_matches_uninterrupted(tmp_path):
    """2 steps with a checkpoint each step, then a resume to step 3, give
    the weights of 3 uninterrupted steps (per-step sampling generators,
    the optimizer and schedule state restored). gamma 1 keeps the rates
    of a 2-step and a 3-step schedule equal."""
    batches = loader_batches(3)
    cfg = pt_tr.TrainConfig(checkpoint_every=1, gamma=1.0, **CFG)
    a = tmp_path / "a"
    final, metrics = pt_tr.train_on_batches(batches, 2, str(a), cfg, max_steps_override=2, device="cpu")
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["total"] > 0
    assert sorted(p.name for p in (a / "ckpts").iterdir()) == ["step_00000001.pt", "step_00000002.pt"]
    final, metrics = pt_tr.train_on_batches(batches, 2, str(a), cfg, max_steps_override=3, device="cpu")
    assert final.endswith("model_final_r50.pt")
    assert sorted(p.name for p in (a / "ckpts").iterdir()) == ["step_00000002.pt", "step_00000003.pt"]
    assert torch.load(a / "ckpts" / "step_00000003.pt", map_location="cpu")["step"] == 3

    b = tmp_path / "b"
    ref_final, ref_metrics = pt_tr.train_on_batches(batches[:2] + batches[:1], 2, str(b), cfg,
                                                    max_steps_override=3, device="cpu")
    # the resumed run restarts its batch stream: step 3 saw batches[0]
    assert metrics == pytest.approx(ref_metrics, rel=1e-6)
    got, ref = _weights(final), _weights(ref_final)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-7, msg=k)


def test_train_fine_tune_freezes_only_with_checkpoint(tmp_path):
    """From scratch every parameter trains (the stem and res2 too); from a
    fine-tune checkpoint the stem, res2 and every norm stay put."""
    batches = loader_batches(1, seed=4)
    cfg = pt_tr.TrainConfig(checkpoint_every=10, base_lr=0.01, **dict(CFG, warmup_iters=0))
    start, _ = pt_tr.train_on_batches(batches, 2, str(tmp_path / "scratch"), cfg, max_steps_override=1,
                                      device="cpu")
    init = _weights(start)
    scratch_model = build_train_model("R50", 2, device="cpu")
    pt_tr.zero_residual_norms(scratch_model)
    moved = {k for k, v in scratch_model.state_dict().items() if not torch.equal(v, init[k])}
    assert {"backbone.bottom_up.stem.conv1.weight", "backbone.bottom_up.res2.0.shortcut.weight",
            "backbone.bottom_up.res2.0.conv3.norm.weight"} <= moved

    tuned, _ = pt_tr.train_on_batches(batches, 2, str(tmp_path / "tune"), cfg, init_checkpoint=start,
                                      max_steps_override=1, device="cpu")
    after = _weights(tuned)
    mask = pt_tr._trainable_mask(scratch_model)
    tuned_moved = {k for k in mask if not torch.equal(after[k], init[k])}
    assert not {k for k in tuned_moved if not mask[k]}
    assert {"roi_heads.box_head.fc1.weight", "backbone.fpn_output2.weight",
            "backbone.bottom_up.res3.0.shortcut.weight"} <= tuned_moved


def test_batch_shape_is_checked():
    cfg = pt_tr.TrainConfig(**CFG)
    batch = loader_batches(1)[0]
    images, gt = pt_tr.batch_to_device(batch, "cpu", cfg)
    assert images.shape == (2, S, S, 3) and gt.masks.shape == (2, 8, S, S) and gt.masks.dtype == torch.bool
    bad = dict(batch, image=batch["image"][:, :32])
    with pytest.raises(ValueError, match="train_size"):
        pt_tr.batch_to_device(bad, "cpu", cfg)
