"""Port parity: the parallel axes on the CPU. The device helpers against the
JAX package's mesh helpers; the member-group rule against
``InferencePipeline._member_meshes`` on the 8 virtual CPU devices; the tile
engine sharded over 2 and 3 CPU shards (and over a second replica) bit for
bit against the one-device engine, and the 2-shard engine against the JAX
engine, at 64x288 and 64x352 (where one dedup decision sits at its
threshold: pinned with its margin); the tile devices ``inference_chips``
chooses. The replica rule and the ensemble's members at once are in
``test_torch_parallel_members.py``."""

import numpy as np
import pytest
import torch

import jax

from deepemia_tpu.inference import engine as jax_engine
from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from deepemia_tpu.parallel import mesh as jax_mesh
from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.inference.pipeline import InferencePipeline
from deepemia_tpu_torch.parallel import mesh as pt_mesh
from tests.test_torch_engine import _assert_sets_match
from tests.test_torch_heads import port_model, sane_geometry

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_partition_devices_matches_jax(n, k):
    assert pt_mesh.partition_devices(list(range(n)), k) == jax_mesh.partition_devices(list(range(n)), k)


def test_tile_devices_follow_tile_mesh(monkeypatch):
    """The JAX ``tile_mesh(n_devices, devices)`` rule: the given devices (by
    default every local one), cut to the first ``n_devices``."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(pt_mesh, "local_devices", lambda: cuda)
    for n in (None, 0, 1, 3, 6):
        ref = list(jax_mesh.tile_mesh(n).devices.flat)
        assert pt_mesh.tile_devices(n, ["cpu"] * 8) == [torch.device("cpu")] * len(ref)
    assert pt_mesh.tile_devices(2) == cuda[:2]
    assert pt_mesh.tile_devices(None, cuda[1:]) == cuda[1:]


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
@pytest.mark.parametrize("n_members", [1, 2, 3])
@pytest.mark.parametrize("enabled", [True, False])
def test_member_groups_match_jax(n_devices, n_members, enabled):
    """Which devices each member gets, as positions in the device list: the
    JAX rule on a tile mesh of ``n_devices`` virtual CPU devices (None for
    one device, as ``_choose_inference_mesh`` returns)."""
    assert len(jax.devices()) >= 8
    mesh = jax_mesh.tile_mesh(n_devices) if n_devices > 1 else None
    ref = JaxPipeline._member_meshes(mesh, n_members, enabled)
    apart = len(ref) > 1 and ref[0] is not ref[1]
    got = InferencePipeline._member_groups(list(range(n_devices)), n_members, enabled)
    assert (got is not None) == apart
    if apart:
        assert got == [[d.id for d in m.devices.flat] for m in ref]


def test_inference_chips_choose_the_tile_devices(monkeypatch):
    cpu = torch.device("cpu")
    for chips, want in ((0, 1), (1, 1), (2, 2), (3, 3)):
        assert InferencePipeline._choose_tile_devices({"inference_chips": chips}, cpu) == [cpu] * want
    cuda = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(pt_mesh, "local_devices", lambda: cuda)
    one = torch.device("cuda")
    assert InferencePipeline._choose_tile_devices({}, one) == cuda
    assert InferencePipeline._choose_tile_devices({"inference_chips": 2}, one) == cuda[:2]
    assert InferencePipeline._choose_tile_devices({"inference_chips": 9}, one) == cuda
    assert InferencePipeline._choose_tile_devices({"inference_chips": 1}, one) == [one]
    assert InferencePipeline._choose_tile_devices({}, torch.device("cuda", 2)) == cuda[2:]
    monkeypatch.setattr(pt_mesh, "local_devices", lambda: cuda[:1])
    assert InferencePipeline._choose_tile_devices({}, one) == [one]


# a 64x288 micrograph in 64 px tiles at overlap 0.1 is a 2x6 grid of 12
# tiles: 3 chunks of 5 (the last of 2), which split 2/1 over 2 shards and
# one each over 3; 64x352 is a 2x7 grid of 14 tiles: 3 chunks (5, 5, 4)
KW = dict(tile_size=64, tile_batch=5, upscale_factor=1.0, full_pass_max_dim=0, confidence_mode="auto")
SETTINGS = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
WIDTHS = (288, 352)


class _DedupInput:
    """Within the block, ``module.dedup_by_mask_iou`` records the set it is
    given (the merged, thresholded set before the dedup) in ``.got``, as
    numpy arrays; through ``jax.debug.callback`` inside the JAX engine's
    program, which then compiles once for both results."""

    def __init__(self, module, traced=False):
        self.module, self.traced, self.got = module, traced, None

    def __enter__(self):
        real = self.real = self.module.dedup_by_mask_iou

        def record(*arrays):
            self.got = InstanceSet(*(np.array(a) for a in arrays))

        def dedup(inst, *a, **kw):
            if self.traced:
                jax.debug.callback(record, *inst)
            else:
                record(*(t.numpy() for t in inst))
            return real(inst, *a, **kw)

        self.module.dedup_by_mask_iou = dedup
        return self

    def __exit__(self, *exc):
        self.module.dedup_by_mask_iou = self.real


@pytest.fixture(scope="module", params=WIDTHS, ids=[f"64x{w}" for w in WIDTHS])
def strip(request, tiny_r50):
    """(JAX model, params, image, settings, the one-device engine's set,
    its quality, the set its dedup took)."""
    model, params = tiny_r50
    params = sane_geometry(params)
    image = (np.random.default_rng(8).random((64, request.param, 3)) * 255).astype(np.uint8)
    settings = pt_engine.class_settings_from_config(SETTINGS, 2)
    one = pt_engine.TileEngine(port_model(params), device="cpu", **KW)
    with _DedupInput(pt_engine) as pre:
        ref, q = one.infer(image, settings)
    return model, params, image, settings, ref, q, pre.got


@pytest.fixture(scope="module")
def jax_strip(strip):
    """The JAX engine on the strip: (its set, its quality, the set its
    dedup took)."""
    model, params, image = strip[:3]
    with _DedupInput(jax_engine, traced=True) as pre:
        ref, q = jax_engine.TileEngine(model, params, **KW).infer(
            image, jax_engine.class_settings_from_config(SETTINGS, 2))
        jax.block_until_ready(ref)
    return ref, q, pre.got


def _shard_run(strip, devices):
    _, params, image, settings = strip[:4]
    eng = pt_engine.TileEngine(port_model(params), device=devices, **KW)
    out = eng.infer(image, settings)
    assert len(eng.replicas) == len(set(devices))
    return out


@pytest.fixture(scope="module")
def two_shards(strip):
    return _shard_run(strip, ["cpu"] * 2)


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu", "cpu:0", "cpu"]], ids=["2-shards", "3-shards-2-replicas"])
def test_sharded_engine_equals_one_device_engine(strip, two_shards, devices):
    """The same InstanceSet bit for bit: every shard runs the one-device
    engine's chunks. ``cpu:0`` is a second name of the CPU, so the engine
    keeps a second replica of the model (a deep copy) for that shard."""
    ref, ref_q = strip[4:6]
    got, q = two_shards if devices == ["cpu"] * 2 else _shard_run(strip, devices)
    assert int(ref.valid.sum()) > 0
    assert torch.equal(q, ref_q)
    for name, a, b in zip(InstanceSet._fields, got, ref):
        assert torch.equal(a, b), name


def test_two_shard_engine_matches_jax(strip, jax_strip, two_shards):
    """At 64x288 the JAX engine's set; at 64x352 the JAX engine's set but
    for the one instance the port keeps and JAX drops
    (``test_64x352_differs_from_jax_at_one_threshold_decision``)."""
    ref, ref_q, _ = jax_strip
    got, q = two_shards
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    assert got.capacity == ref.capacity and int(np.asarray(ref.valid).sum()) > 0
    extra = got.valid.numpy() & ~np.asarray(ref.valid)
    assert not (np.asarray(ref.valid) & ~got.valid.numpy()).any()
    assert int(extra.sum()) == (1 if strip[2].shape[1] == 352 else 0)
    _assert_sets_match(got._replace(valid=got.valid & ~torch.from_numpy(extra)), ref, box_atol=1e-3)


# the instance the port keeps at 64x352 and the JAX engine drops, and the
# one JAX drops it for (rows of the merged set, before the dedup)
KEPT_BOX = [181.74, 38.50, 197.57, 64.00]


def test_64x352_differs_from_jax_at_one_threshold_decision(strip, jax_strip):
    """A last-bit difference at a threshold, not a departure from the JAX
    semantics. The merged sets the two dedups take agree (the same rows,
    scores and classes; boxes within 1e-3 px, mask probabilities within
    1e-4, ``test_torch_engine``'s limits). Given the same input, the port's dedup keeps what JAX's keeps.
    The port keeps one instance more: the row at ``KEPT_BOX`` (score 1.0,
    class 0). Its low-res paste (stride 8) differs in one cell, whose
    bilinear probability lies within 5e-5 of the 0.5 mask threshold: just
    below it from the port's input, at or above it from JAX's. That cell
    lifts the row's mask IoU with the earlier, kept row it overlaps from
    2/7 to 3/7 across the dedup's 0.4, so JAX suppresses it. At 64x288
    nothing sits at a threshold and the sets are equal."""
    from deepemia_tpu_torch.inference import detections as pt_det
    from deepemia_tpu_torch.ops import masks as pt_masks

    image, ref = strip[2], strip[4]
    pre, jax_ref, jax_pre = strip[6], jax_strip[0], jax_strip[2]
    v = pre.valid
    np.testing.assert_array_equal(v, jax_pre.valid)
    np.testing.assert_array_equal(pre.classes[v], jax_pre.classes[v])
    np.testing.assert_array_equal(pre.scores[v], jax_pre.scores[v])
    np.testing.assert_allclose(pre.boxes[v], jax_pre.boxes[v], atol=1e-3)
    np.testing.assert_allclose(pre.mask_probs[v], jax_pre.mask_probs[v], atol=1e-4)
    hw, stride, iou_thr = image.shape[:2], 8, 0.4
    dedup = pt_det.dedup_by_mask_iou(InstanceSet(*(torch.tensor(a) for a in jax_pre)), hw, iou_thr, stride)
    np.testing.assert_array_equal(dedup.valid.numpy(), np.asarray(jax_ref.valid))
    extra = np.nonzero(ref.valid.numpy() & ~np.asarray(jax_ref.valid))[0]
    if image.shape[1] == 288:
        assert len(extra) == 0 and torch.equal(ref.valid, torch.tensor(np.asarray(jax_ref.valid)))
        return
    assert len(extra) == 1
    i = int(extra[0])
    assert pre.scores[i] == 1.0 and pre.classes[i] == 0
    np.testing.assert_allclose(pre.boxes[i], KEPT_BOX, atol=1e-2)

    def lowres(s, thr=0.5):
        b = torch.from_numpy(s.boxes) / float(stride)
        return pt_masks.paste_masks(torch.from_numpy(s.mask_probs), b, 8, hw[1] // stride, thr).numpy()

    port_lm, jax_lm = lowres(pre), lowres(jax_pre)
    cells = np.argwhere(port_lm[i] != jax_lm[i])
    assert len(cells) == 1 and not port_lm[i][tuple(cells[0])] and jax_lm[i][tuple(cells[0])]
    margin = 5e-5
    assert lowres(pre, 0.5 - margin)[i][tuple(cells[0])] and not lowres(jax_pre, 0.5 + margin)[i][tuple(cells[0])]
    port_iou = pt_masks.mask_iou_matrix(torch.from_numpy(port_lm), torch.from_numpy(port_lm)).numpy()[i]
    jax_iou = pt_masks.mask_iou_matrix(torch.from_numpy(jax_lm), torch.from_numpy(jax_lm)).numpy()[i]
    same = (pre.classes == pre.classes[i]) & np.asarray(jax_ref.valid) & (np.arange(len(v)) < i)
    suppressor = np.nonzero(same & (jax_iou > iou_thr))[0]
    assert len(suppressor) == 1 and not (same & (port_iou > iou_thr)).any()
    j = int(suppressor[0])
    assert (port_iou[j], jax_iou[j]) == (np.float32(2 / 7), np.float32(3 / 7))


def test_maybe_init_distributed(monkeypatch):
    """Nothing set: nothing starts. torchrun's variables for one gloo rank:
    a process group of one. Asked for and unable to start: PipelineError
    (the JAX function warns and runs on one host)."""
    import torch.distributed as dist

    from deepemia_tpu_torch.utils.device import maybe_init_distributed
    from deepemia_tpu_torch.utils.exceptions import PipelineError

    for k in ("DEEPEMIA_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed("cpu") is False and not dist.is_initialized()
    monkeypatch.setenv("DEEPEMIA_DISTRIBUTED", "1")
    with pytest.raises(PipelineError, match="MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE"):
        maybe_init_distributed("cpu")
    from deepemia_tpu_torch.train.trainer import _free_port

    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port())), ("RANK", "zero"),
                 ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(PipelineError, match="failed to start"):
        maybe_init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    try:
        assert maybe_init_distributed("cpu") is True
        assert (dist.get_rank(), dist.get_world_size(), dist.get_backend()) == (0, 1, "gloo")
        assert maybe_init_distributed("cpu") is True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
