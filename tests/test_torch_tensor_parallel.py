"""Port parity: the tensor-parallel box head (``TrainConfig.n_model_shards``)
on the CPU. The (data, model) layout against the JAX trainer's
``make_mesh`` for 1 to 8 devices; ``BoxHead`` split over 2 and 3 gloo ranks
(blocks of 512 and 342/341/341 outputs) against the whole head, forward and
backward; train steps at data 1 x model 2 and data 2 x model 2 against one
process on the same global batch and draws (the JAX test's batch, the JAX
key chain's draws, the clip engaged), and the 2 x 2 step's losses against
the JAX 4 x 2 sharded step's; checkpoints in the one-process format that
resume across the two layouts.

Ranks are spawned processes of one gloo group, each joined with a
deadline (``RANK_TIMEOUT``) and one torch thread, so a hang fails the
test."""

import copy
import datetime
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepemia_tpu_torch.models.heads import BoxHead, block_bounds
from deepemia_tpu_torch.models.mask_rcnn import build_train_model
from deepemia_tpu_torch.parallel.mesh import train_layout
from deepemia_tpu_torch.train import trainer as pt_tr
from torch_tmp_weights import drop_weights, remove_weights  # noqa: F401 - drop_weights: autouse

torch.set_num_threads(2)

# a spawned rank that has not finished by then is killed and fails its test
RANK_TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, args, launcher):
    """A spawned rank: one torch thread; the gloo group joined here (with a
    timeout), or, with ``launcher``, left to ``fn`` through torchrun's
    variables (``maybe_init_distributed``)."""
    torch.set_num_threads(1)
    if launcher:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT // 2))
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, *args, launcher=False, timeout=RANK_TIMEOUT):
    """``fn(rank, world, *args)`` in ``world`` spawned processes, the ranks
    of one gloo group; each joined by a deadline ``timeout`` seconds after
    the start. A rank still running then is killed, and the test fails, as
    it does when a rank exits nonzero."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, port, args, launcher), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"rank(s) {hung} of {world} still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]


@pytest.mark.parametrize("ims", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("n_model", [1, 2, 3, 4])
@pytest.mark.parametrize("n", range(1, 9))
def test_layout_follows_the_jax_mesh(n, n_model, ims, monkeypatch):
    """``train_layout(n, n_model, ims)`` is the shape of the JAX trainer's
    ``make_mesh(n_model, max_data=ims)`` over the first n of the 8 virtual
    devices, where that mesh splits the batch evenly; where it does not
    (a batch of 6 on 4 data devices), JAX cannot shard the batch and the
    port takes the gcd of the two."""
    import jax

    from deepemia_tpu.train.trainer import make_mesh

    devices = jax.devices()
    assert len(devices) == 8
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:n])
    data, model = make_mesh(n_model, max_data=ims).devices.shape
    got = train_layout(n, n_model, ims)
    assert got == ((data, model) if ims % data == 0 else (np.gcd(data, ims), model))


def test_blocks_cover_the_head():
    for n in (1, 2, 3, 4, 5, 7):
        bounds = [block_bounds(1024, i, n) for i in range(n)]
        assert bounds[0][0] == 0 and bounds[-1][1] == 1024
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [b - a for a, b in bounds]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


# BoxHead on the ranks vs the whole head, float32: largest difference over
# the whole head's largest magnitude
HEAD_REL = 1e-6


def _head_rank(rank, world, out):
    """The whole head and its blocks over ranks [0, 1] and [0, 1, 2]: one
    forward and backward of 16 RoIs each; the outputs, the input's gradient
    and every parameter's gradient (blocks gathered, fc1's bias summed)
    against the whole head's, as ratios to its largest magnitude."""
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    whole = BoxHead()
    x = torch.randn(16, 7, 7, 256, generator=gen)
    cot = torch.randn(16, 1024, generator=gen)
    xr = x.clone().requires_grad_()
    (whole(xr) * cot).sum().backward()
    ref = {"out": whole(x).detach(), "input": xr.grad, **{n: p.grad for n, p in whole.named_parameters()}}
    groups = {2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2])}
    report = {}
    for n, group in groups.items():
        if rank >= n:
            continue
        head = copy.deepcopy(whole)
        head.zero_grad()
        head.shard(group, rank, n)
        xt = x.clone().requires_grad_()
        y = head(xt)
        (y * cot).sum().backward()
        got = {"out": y.detach(), "input": xt.grad, "fc1.bias": dist_sum(head.fc1.bias.grad, group),
               "fc2.bias": head.fc2.bias.grad, "fc1.weight": head.gather("fc1.weight", head.fc1.weight.grad),
               "fc2.weight": head.gather("fc2.weight", head.fc2.weight.grad)}
        report[n] = {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref}
        report[n]["block"] = tuple(head.fc1.weight.shape)
    torch.save(report, os.path.join(out, f"rank{rank}.pt"))


def dist_sum(t, group):
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def test_box_head_blocks_equal_the_whole_head(tmp_path):
    """fc1 column-parallel and fc2 row-parallel over 2 ranks (blocks of 512)
    and over 3 (342, 341, 341: uneven, where GSPMD pads): the output, the
    input's gradient (summed over the group backward) and every parameter's
    gradient equal the whole head's on every rank."""
    run_ranks(_head_rank, 3, str(tmp_path))
    for rank in range(3):
        report = torch.load(tmp_path / f"rank{rank}.pt")
        assert sorted(report) == [n for n in (2, 3) if rank < n]
        for n, rel in report.items():
            assert rel.pop("block") == (block_bounds(1024, rank, n)[1] - block_bounds(1024, rank, n)[0], 12544)
            assert max(rel.values()) <= HEAD_REL, (rank, n, rel)


# the JAX test's batch (tests/test_parallel.py:test_sharded_train_step_
# matches_single_device): 4 float images of 64², one GT square each
B, S, G = 4, 64, 2
CAPS = dict(pre_nms_topk=64, post_nms_topk=32, rpn_batch=32, roi_batch=32, mask_rois=8)
N_ANCHORS = 3 * sum((S // s) ** 2 for s in (4, 8, 16, 32, 64))
N_ROIS = CAPS["post_nms_topk"] + G
# the first step's gradient norm is ~1.6e4 at these weights, about half of
# its square in the box head's two weight matrices: the clip at 1e3 scales
# every step, so a norm that left the blocks out or counted them twice, or
# a sum in place of a mean, moves every weight. At random weights a step
# moves the losses by ~1e2 a unit of rate; at 1e-6 the float32 noise of
# the clip's norm (NORM_REL) stays far below the losses' limit
CFG = dict(train_size=S, max_instances=G, ims_per_batch=B, use_bf16=False, warmup_iters=0, base_lr=1e-6,
           grad_clip_norm=1e3, loss_caps=CAPS)
# weights after two steps: within REL of each tensor's largest entry or of
# the largest update (tests/test_torch_ddp.py); losses to the JAX test's 1e-4
REL = 1e-5
LOSS_REL = 1e-4
# the global gradient norm the clip takes, ranks vs one process: float32
# sums of squares (12.8M of them in fc1's weight) taken in other groupings
# differ by ~2e-4 relative, as far as one process's float32 norm lies from
# the float64 one (~3e-4); a norm that left the box head's blocks out would
# be ~30 % short, one that counted them twice ~40 % long
NORM_REL = 1e-3


def _jax_batch():
    rng = np.random.default_rng(3)
    masks = np.zeros((B, G, S, S), bool)
    boxes = np.zeros((B, G, 4), np.float32)
    for i in range(B):
        y, x = rng.integers(8, 30, 2)
        masks[i, 0, y:y + 16, x:x + 16] = True
        boxes[i, 0] = [x, y, x + 16, y + 16]
    return {"image": (rng.random((B, S, S, 3)) * 255).astype(np.float32), "gt_boxes": boxes,
            "gt_classes": np.zeros((B, G), np.int32),
            "gt_valid": np.concatenate([np.ones((B, 1), bool), np.zeros((B, G - 1), bool)], axis=1),
            "gt_masks": masks}


def _jax_draws(key):
    """The JAX step's draws for each image of the batch (its key chain:
    one key per image, then (rpn, roi), then (positive, negative))."""
    import jax

    from deepemia_tpu_torch.train.losses import Draws

    out = []
    for r in jax.random.split(key, B):
        per = []
        for k, n in zip(jax.random.split(r), (N_ANCHORS, N_ROIS)):
            pos, neg = jax.random.split(k)
            per += [jax.random.uniform(pos, (n,)), jax.random.uniform(neg, (n,))]
        out.append(Draws(*(torch.from_numpy(np.array(d)) for d in per)))
    return out


def _steps(state, batches, draws, n_model=1):
    """``train_step`` from ``state`` on this rank's data block of each
    batch with its draws, the box head split over the model group -> (the
    one-process state dicts after the steps, each step's losses, each
    step's global gradient norm, the layout, {split parameter: (its index in
    the optimizer, this rank's momentum block)})."""
    cfg = pt_tr.TrainConfig(**CFG, n_model_shards=n_model)
    layout = pt_tr.rank_layout(n_model, B)
    model = build_train_model("R50", 2, device="cpu")
    model.load_state_dict(state)
    if layout.model > 1:
        model.roi_heads.box_head.shard(layout.model_group, layout.m, layout.model)
    opt, sched = pt_tr.make_optimizer(list(model.parameters()), cfg.base_lr, 10, cfg.warmup_iters)
    norms, real = [], pt_tr.clip_gradients

    def clip(*a, **kw):
        norms.append(float(real(*a, **kw)))
        return norms[-1]

    pt_tr.clip_gradients = clip
    block = B // layout.data
    names = [n for n, _ in model.named_parameters()]
    metrics = []
    try:
        for batch, step_draws in zip(batches, draws):
            mine = step_draws[layout.d * block : (layout.d + 1) * block]
            metrics.append(pt_tr.train_step(model, opt, sched, pt_tr.shard_batch(batch, layout.d, layout.data),
                                            cfg, draws=mine, layout=layout))
    finally:
        pt_tr.clip_gradients = real
    sd, opt_sd = pt_tr.full_state(model, opt)
    params = dict(model.named_parameters())
    blocks = {k: (names.index(k), opt.state[params[k]]["momentum_buffer"].clone()) for k in params
              if getattr(params[k], "model_split", None) == "block"}
    return sd, opt_sd, metrics, norms, layout, blocks


def _tp_rank(rank, world, n_model, start_path, batches, draws, out):
    state = torch.load(start_path, map_location="cpu")
    sd, opt_sd, metrics, norms, layout, blocks = _steps(state, batches, draws, n_model)
    torch.save({"model": sd, "optimizer": opt_sd, "metrics": metrics, "norms": norms, "blocks": blocks,
                "layout": (layout.data, layout.model, layout.d, layout.m)}, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def reference(tiny_r50, tmp_path_factory):
    """tiny_r50's weights (as the JAX test takes them) in the port's
    trainer model, two batches (the JAX test's, then its images mirrored)
    with the JAX key chain's draws (keys 9 and 10), and two steps of one
    process on them."""
    import jax

    from tests.test_torch_heads import port_model

    state = port_model(tiny_r50[1]).state_dict()
    first = _jax_batch()
    second = {**first, "image": first["image"][:, :, ::-1].copy()}
    batches, draws = [first, second], [_jax_draws(jax.random.PRNGKey(9 + s)) for s in range(2)]
    path = tmp_path_factory.mktemp("tp_start") / "start.pt"
    torch.save(state, path)
    ref, ref_opt, ref_metrics, ref_norms, _, _ = _steps(state, batches, draws)
    yield dict(state=state, path=str(path), batches=batches, draws=draws, ref=ref, ref_opt=ref_opt,
               metrics=ref_metrics, norms=ref_norms)
    os.remove(path)


def _assert_weights_close(got, ref, start):
    """Each tensor within REL of its largest entry, or of the run's largest
    update where that is larger."""
    update = max(float((ref[k].float() - start[k].float()).abs().max()) for k in ref)
    assert update > 0
    for k in ref:
        scale = max(float(ref[k].abs().max()), update)
        diff = float((got[k] - ref[k]).abs().max())
        assert diff <= REL * scale, (k, diff, scale)


@pytest.fixture(scope="module")
def two_by_two(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_2x2")
    run_ranks(_tp_rank, 4, 2, reference["path"], reference["batches"], reference["draws"], str(out))
    got = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    remove_weights(out)
    return got


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_tensor_parallel_steps_equal_one_process(reference, two_by_two, shape, tmp_path):
    """Two steps at data 1 x model 2 and data 2 x model 2: every rank's
    place ``divmod(rank, 2)``, the global gradient norm the clip takes
    (to NORM_REL) and the losses those of one process; rank 0's
    weights, gathered into the one-process format, within REL of one
    process's, and its momentum in that format: the shapes of one
    process's, each rank's block of fc1's and fc2's in its place."""
    if shape == "2x2":
        got = two_by_two
    else:
        run_ranks(_tp_rank, 2, 2, reference["path"], reference["batches"], reference["draws"], str(tmp_path))
        got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    data = len(got) // 2
    state, ref = reference["state"], reference["ref"]
    moved = [k for k in ref if not torch.equal(ref[k], state[k])]
    assert len(moved) > 100
    for rank, g in enumerate(got):
        assert g["layout"] == (data, 2, *divmod(rank, 2))
        assert g["norms"] == pytest.approx(reference["norms"], rel=NORM_REL)
        assert min(reference["norms"]) > CFG["grad_clip_norm"]
        for m_got, m_ref in zip(g["metrics"], reference["metrics"]):
            assert m_got == pytest.approx(m_ref, rel=LOSS_REL)
    _assert_weights_close(got[0]["model"], ref, state)
    momentum = {i: s["momentum_buffer"] for i, s in reference["ref_opt"]["state"].items()}
    got_momentum = {i: s["momentum_buffer"] for i, s in got[0]["optimizer"]["state"].items()}
    assert sorted(got_momentum) == sorted(momentum)
    assert all(got_momentum[i].shape == momentum[i].shape for i in momentum)
    for rank, g in enumerate(got):
        assert sorted(g["blocks"]) == ["roi_heads.box_head.fc1.weight", "roi_heads.box_head.fc2.weight"]
        a, b = block_bounds(1024, rank % 2, 2)
        for key, (i, block) in g["blocks"].items():
            dim = BoxHead.SPLIT[key.rsplit(".", 2)[-2] + ".weight"]
            assert torch.equal(got_momentum[i].narrow(dim, a, b - a), block), (rank, key)


def test_two_by_two_step_matches_the_jax_sharded_step(tiny_r50, reference, two_by_two):
    """The JAX trainer's step on its 4 x 2 (data, model) mesh of the 8
    virtual devices (``build_train_step`` on ``make_mesh(2)``, the JAX
    test's batch and key 9) and the port's first step at data 2 x model 2
    with that key chain's draws: the same losses, to 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from deepemia_tpu.train.trainer import TrainState, build_train_step, make_mesh, make_optimizer, state_shardings

    model, params = tiny_r50
    mesh = make_mesh(2)
    assert mesh.devices.shape == (4, 2)
    params = jax.tree.map(jnp.asarray, jax.device_get(params))
    tx = make_optimizer(2.5e-4, 100, 10, params=params)
    state = TrainState.create(params, tx)
    step_fn, shardings = build_train_step(model, mesh, tx, CAPS, state_template=state)
    state = jax.device_put(state, state_shardings(state, mesh))
    batch = {k: jax.device_put(v, shardings[k]) for k, v in _jax_batch().items()}
    _, metrics = step_fn(state, batch, jax.random.PRNGKey(9))
    ref = {k: float(v) for k, v in metrics.items()}
    for rank in range(4):
        got = two_by_two[rank]["metrics"][0]
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=LOSS_REL), (rank, k, got[k], ref[k])


# resuming across the layouts: train_on_batches with the trainer's own
# draws, 2 images a step, a checkpoint every step, one rate for every step
# (runs of 1, 2 and 3 steps share the schedule)
RESUME_CFG = dict(CFG, ims_per_batch=2, gamma=1.0, checkpoint_every=1)


def _resume_batches():
    """One batch, repeated: a resumed run restarts the batch stream, as the
    JAX loader does, so every step must see the same batch (the draws still
    follow the step)."""
    return [{k: v[:2] for k, v in _jax_batch().items()}]


def _launched_tp_rank(rank, world, start, out_dir):
    """A launcher's rank (``maybe_init_distributed``): resume ``out_dir``'s
    one-process checkpoint at data 1 x model 2 and train to step 2."""
    from deepemia_tpu_torch.utils.device import maybe_init_distributed

    assert maybe_init_distributed("cpu")
    cfg = pt_tr.TrainConfig(**RESUME_CFG, n_model_shards=2)
    pt_tr.train_on_batches(_resume_batches(), 2, out_dir, cfg, init_checkpoint=start, max_steps_override=2,
                           device="cpu")


def test_checkpoints_resume_across_the_layouts(reference, tmp_path):
    """One process's step-1 checkpoint resumes on two launcher ranks at
    data 1 x model 2, whose rank 0 writes step 2 in the one-process format
    (the blocks and their momentum gathered); that checkpoint resumes in
    one process for step 3. Each run's weights are within REL of one
    uninterrupted process's at the same step."""
    start = str(tmp_path / "start.pt")
    torch.save({"model": reference["state"]}, start)
    cfg = pt_tr.TrainConfig(**RESUME_CFG)
    whole = tmp_path / "whole"
    pt_tr.train_on_batches(_resume_batches(), 2, str(whole), cfg, init_checkpoint=start, max_steps_override=3,
                           device="cpu")
    ckpts = {n: torch.load(whole / "ckpts" / f"step_0000000{n}.pt", map_location="cpu") for n in (2, 3)}
    parted = tmp_path / "parted"
    (parted / "ckpts").mkdir(parents=True)
    pt_tr.train_on_batches(_resume_batches(), 2, str(parted), cfg, init_checkpoint=start, max_steps_override=1,
                           device="cpu")
    run_ranks(_launched_tp_rank, 2, start, str(parted), launcher=True)
    step2 = torch.load(parted / "ckpts" / "step_00000002.pt", map_location="cpu")
    assert step2["step"] == 2 and step2["model"]["roi_heads.box_head.fc1.weight"].shape == (1024, 12544)
    _assert_weights_close(step2["model"], ckpts[2]["model"], reference["state"])
    final, _ = pt_tr.train_on_batches(_resume_batches(), 2, str(parted), cfg, init_checkpoint=start,
                                      max_steps_override=3, device="cpu")
    _assert_weights_close(torch.load(final, map_location="cpu")["model"], ckpts[3]["model"], reference["state"])


def test_a_group_of_the_wrong_size_is_refused(monkeypatch):
    """A launcher's group that is not ``data * model`` of the layout is
    refused before step 0, naming the rule."""
    monkeypatch.setattr(pt_tr, "process_group", lambda: (0, 3))
    with pytest.raises(ValueError, match=r"train_layout\(3, 2, 2\) = \(data 1, model 1\): 1 ranks"):
        pt_tr.rank_layout(2, 2)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        pt_tr.rank_devices("cpu", ["cpu"] * 3, 2, 2)
    assert pt_tr.rank_devices("cpu", ["cpu"] * 4, 2, 2) == [torch.device("cpu")] * 4
