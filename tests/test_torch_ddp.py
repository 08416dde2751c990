"""Port parity: data-parallel training on the CPU. The number of ranks
against the JAX trainer's data axis on the 8 virtual CPU devices; each
image's sampling draws as a function of (seed, step, its index in the
global batch); two gloo ranks started by ``torch.multiprocessing`` against
one process on the global batch, with injected JAX draws through
``train_step``, through ``train_on_batches`` with the trainer's own
draws, and as ranks a launcher starts (``maybe_init_distributed``): the
same weights after two steps, to 1e-5 relative (of each tensor's largest
entry, or of the largest update), and the same losses to 1e-4 relative;
the GPU index an NCCL barrier gets."""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepemia_tpu_torch.models.mask_rcnn import build_train_model
from deepemia_tpu_torch.train import trainer as pt_tr
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)

S = 64
CFG = dict(
    train_size=S, max_instances=8, use_bf16=False, warmup_iters=0, log_every=1, base_lr=1e-6, grad_clip_norm=1e4,
    checkpoint_every=1, loss_caps=dict(pre_nms_topk=128, post_nms_topk=64, rpn_batch=64, roi_batch=64, mask_rois=16),
)
N_ANCHORS = 3 * sum((S // s) ** 2 for s in (4, 8, 16, 32, 64))  # p2..p6, 3 aspect ratios
N_ROIS = CFG["loss_caps"]["post_nms_topk"] + CFG["max_instances"]  # proposals + GT rows
# the first step's gradient norm is ~7.4e3 at these weights: a rate of 1e-6
# moves every weight without blowing up, and the clip at 1e4 stays open
# (a sum over the ranks in place of the mean would trip it)
REL = 1e-5
# losses after an update: the card's card-vs-CPU loss limit (chip_smoke.py LOSS_RTOL)
LOSS_REL = 1e-4


@pytest.mark.parametrize("ims", [1, 2, 3, 4, 6, 8, 16])
def test_ranks_follow_the_jax_data_axis(ims):
    import jax

    from deepemia_tpu.train.trainer import make_mesh

    assert len(jax.devices()) == 8
    assert pt_tr.train_layout(8, 1, ims) == make_mesh(1, max_data=ims).devices.shape


def test_ranks_split_every_batch_evenly():
    # where the JAX rule cannot shard (12 images on 8 devices) the gcd
    assert [pt_tr.train_layout(n, 1, 12)[0] for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 3, 4, 1, 4]
    with pytest.raises(ValueError, match="does not split"):
        pt_tr.rank_devices("cpu", ["cpu"] * 3, 2)
    assert pt_tr.rank_devices("cpu", None, 2) is None and pt_tr.rank_devices("cpu", ["cpu"], 2) is None


def test_image_draws_follow_the_global_image():
    """Image i of a step draws the same on any rank; a resumed run's step
    draws what the uninterrupted run's did (a function of the step alone);
    images, steps and seeds draw apart."""
    def draws(seed, step, images):
        return [torch.rand(32, generator=g) for g in pt_tr.image_generators(seed, step, images, "cpu")]

    whole = draws(0, 5, range(4))
    blocks = draws(0, 5, range(2)) + draws(0, 5, range(2, 4))
    assert all(torch.equal(a, b) for a, b in zip(whole, blocks))
    assert torch.equal(draws(0, 5, [3])[0], whole[3])
    assert not torch.equal(whole[0], whole[1])
    assert not torch.equal(draws(0, 6, [0])[0], whole[0]) and not torch.equal(draws(1, 5, [0])[0], whole[0])


def _batches(n, seed=0):
    """Global batches of 2 images in the loader's format: bright disks on a
    noisy background, padded GT, bit-packed masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S]
    out = []
    for _ in range(n):
        img = (rng.random((2, S, S, 3)) * 50 + 40).astype(np.uint8)
        boxes = np.zeros((2, 8, 4), np.float32)
        valid = np.zeros((2, 8), bool)
        masks = np.zeros((2, 8, S, S), bool)
        for i in range(2):
            for j in range(3):
                cy, cx, r = rng.integers(12, S - 12), rng.integers(12, S - 12), rng.integers(5, 10)
                m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                masks[i, j], valid[i, j] = m, True
                ys, xs = np.nonzero(m)
                boxes[i, j] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                img[i][m] = 200
        out.append(dict(image=img, gt_boxes=boxes, gt_classes=(np.arange(16).reshape(2, 8) % 2).astype(np.int32),
                        gt_valid=valid, gt_masks=np.packbits(masks, axis=-1)))
    return out


def _steps(state, batches, draws, rank=0, world=1):
    """Two SGD steps of ``train_step`` from ``state`` on this rank's block
    of each global batch, with its block of the injected draws."""
    cfg = pt_tr.TrainConfig(**CFG)
    model = build_train_model("R50", 2, device="cpu")
    model.load_state_dict(state)
    opt, sched = pt_tr.make_optimizer(list(model.parameters()), cfg.base_lr, 10, cfg.warmup_iters)
    block = cfg.ims_per_batch // world
    metrics = []
    for batch, step_draws in zip(batches, draws):
        mine = step_draws[rank * block : (rank + 1) * block]
        metrics.append(pt_tr.train_step(model, opt, sched, pt_tr.shard_batch(batch, rank, world), cfg, draws=mine))
    return model.state_dict(), metrics


def _rank_steps(rank, world, port, start_path, batches, draws, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        torch.set_num_threads(1)
        state = torch.load(start_path, map_location="cpu")["model"]
        weights, metrics = _steps(state, batches, draws, rank, world)
        if rank == 0:
            torch.save({"model": weights, "metrics": metrics}, out_path)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def start(tiny_r50, tmp_path_factory):
    """tiny_r50's weights in the port's trainer model, as a state dict and
    as the ``.pt`` file ``train_on_batches`` fine-tunes from."""
    from tests.test_torch_heads import port_model, sane_geometry

    state = port_model(sane_geometry(tiny_r50[1])).state_dict()
    path = tmp_path_factory.mktemp("ddp_start") / "start.pt"
    torch.save({"model": state}, path)
    yield state, str(path)
    os.remove(path)


def _assert_weights_close(got, ref, start):
    """Each tensor within REL of its largest entry, or of the run's largest
    update where that is larger (a tensor that started at zero holds only
    its updates, whose float32 sums the ranks take in another order)."""
    update = max(float((ref[k].float() - start[k].float()).abs().max()) for k in ref)
    assert update > 0
    for k in ref:
        scale = max(float(ref[k].abs().max()), update)
        diff = float((got[k] - ref[k]).abs().max())
        assert diff <= REL * scale, (k, diff, scale)


def test_two_gloo_ranks_step_as_one_process(start, tmp_path):
    """Injected draws (the JAX trainer's key chain, one key per image of
    the global batch): rank r steps on block r with draws r, the
    gradients averaged across the ranks."""
    import jax

    from tests.test_torch_losses import jax_draws

    state, path = start
    batches = _batches(2, seed=3)
    draws = [jax_draws(jax.random.PRNGKey(10 + step), N_ANCHORS, N_ROIS) for step in range(2)]
    ref, ref_metrics = _steps(state, batches, draws)
    out = tmp_path / "ranks.pt"
    mp.start_processes(_rank_steps, args=(2, _free_port(), path, batches, draws, str(out)), nprocs=2, join=True,
                       start_method="spawn")
    got = torch.load(out, map_location="cpu")
    moved = [k for k in ref if not torch.equal(ref[k], state[k])]
    assert len(moved) > 100
    _assert_weights_close(got["model"], ref, state)
    for m_got, m_ref in zip(got["metrics"], ref_metrics):
        assert m_got == pytest.approx(m_ref, rel=LOSS_REL)


@pytest.fixture(scope="module")
def one_process_run(start, tmp_path_factory):
    """``train_on_batches`` in one process for two steps on two global
    batches -> (batches, final weights, last losses)."""
    batches = _batches(2, seed=5)
    out = tmp_path_factory.mktemp("one_process")
    final, metrics = pt_tr.train_on_batches(batches, 2, str(out), pt_tr.TrainConfig(**CFG), init_checkpoint=start[1],
                                            max_steps_override=2, device="cpu")
    weights = torch.load(final, map_location="cpu")["model"]
    os.remove(final)
    return batches, weights, metrics


def _assert_run_as_one_process(out_dir, final, metrics, one_process_run, start):
    """A data-parallel run's checkpoints, final weights and losses against
    the one-process run's."""
    _, ref, ref_metrics = one_process_run
    assert final == str(out_dir / "model_final_r50.pt")
    assert sorted(p.name for p in (out_dir / "ckpts").iterdir()) == ["step_00000001.pt", "step_00000002.pt"]
    assert metrics == pytest.approx(ref_metrics, rel=LOSS_REL)
    _assert_weights_close(torch.load(final, map_location="cpu")["model"], ref, start[0])


def test_train_on_batches_on_two_ranks_as_one_process(start, one_process_run, tmp_path):
    """``train_on_batches(devices=[cpu, cpu])`` starts two gloo ranks
    itself; with the trainer's own per-image draws its weights, checkpoints
    and losses are the one-process run's."""
    batches = one_process_run[0]
    final, metrics = pt_tr.train_on_batches(batches, 2, str(tmp_path / "two"), pt_tr.TrainConfig(**CFG),
                                            init_checkpoint=start[1], max_steps_override=2, device="cpu",
                                            devices=["cpu", "cpu"])
    _assert_run_as_one_process(tmp_path / "two", final, metrics, one_process_run, start)


def _launched_rank(rank, world, port, init, batches, out_dir, results):
    """A rank as a launcher starts it: torchrun's variables, then
    ``maybe_init_distributed``; a batch that does not split over the group
    refused, then two steps with a checkpoint after each."""
    from deepemia_tpu_torch.utils.device import maybe_init_distributed

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu")
    try:
        try:
            pt_tr.train_on_batches(batches, 2, out_dir, pt_tr.TrainConfig(**{**CFG, "ims_per_batch": 1}),
                                   device="cpu")
            refused = None
        except ValueError as e:
            refused = str(e)
        final, metrics = pt_tr.train_on_batches(batches, 2, out_dir, pt_tr.TrainConfig(**CFG), init_checkpoint=init,
                                                max_steps_override=2, device="cpu")
        results.put((rank, refused, final, metrics))
    finally:
        dist.destroy_process_group()


def test_launcher_ranks_train_as_one_process(start, one_process_run, tmp_path):
    """Two ranks started as ``torchrun`` starts them (``env://`` through
    ``maybe_init_distributed``, gloo): ``ims_per_batch`` 1 is refused by
    the data-axis rule; with 2, both ranks pass the checkpoint barriers
    and return rank 0's final weights, which are the one-process run's."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_launched_rank, args=(2, _free_port(), start[1], one_process_run[0], str(tmp_path), results),
                       nprocs=2, join=True, start_method="spawn")
    got = sorted(results.get() for _ in range(2))
    assert [r for r, *_ in got] == [0, 1]
    for _, refused, final, metrics in got:
        assert "train_layout(2, 1, 1) = (data 1, model 1): 1 ranks" in refused
        assert "torchrun --nproc_per_node 1" in refused
        _assert_run_as_one_process(tmp_path, final, metrics, one_process_run, start)


def test_nccl_barrier_names_the_current_gpu(monkeypatch):
    """In an NCCL group, a rank given ``cuda`` (as a launcher's rank is)
    trains on the current GPU by its index, which the barrier passes on;
    outside a group there is no barrier."""
    calls = []
    monkeypatch.setattr(pt_tr, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(dist, "barrier", lambda **kw: calls.append(kw))
    pt_tr._barrier(pt_tr._indexed_device("cuda"))
    assert calls == []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    assert pt_tr._indexed_device("cuda:1") == torch.device("cuda", 1)
    pt_tr._barrier(pt_tr._indexed_device("cuda"))
    assert calls == [{"device_ids": [3]}]
