"""Port parity: the parallel axes on the CPU. The device helpers against the
JAX package's mesh helpers; the member-group rule against
``InferencePipeline._member_meshes`` on the 8 virtual CPU devices; the tile
engine sharded over 2 and 3 CPU shards (and over a second replica) bit for
bit against the one-device engine, with a replica only where a block runs,
and the 2-shard engine against the JAX engine; the ensemble's members run at once against in turn, alone and in
the pipeline; the tile devices ``inference_chips`` chooses."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deepemia_tpu.inference import engine as jax_engine
from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from deepemia_tpu.parallel import mesh as jax_mesh
from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.inference import ensemble as pt_ens
from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.inference.pipeline import InferencePipeline
from deepemia_tpu_torch.parallel import mesh as pt_mesh
from tests.test_torch_engine import _assert_sets_match, _instances
from tests.test_torch_heads import port_model, sane_geometry
from tests.test_torch_pipeline import _write_checkpoint, _zoo_state_dict, golden  # noqa: F401 - golden: a fixture
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

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
# one each over 3
KW = dict(tile_size=64, tile_batch=5, upscale_factor=1.0, full_pass_max_dim=0, confidence_mode="auto")
SETTINGS = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}


@pytest.fixture(scope="module")
def strip(tiny_r50):
    model, params = tiny_r50
    params = sane_geometry(params)
    image = (np.random.default_rng(8).random((64, 288, 3)) * 255).astype(np.uint8)
    settings = pt_engine.class_settings_from_config(SETTINGS, 2)
    one = pt_engine.TileEngine(port_model(params), device="cpu", **KW)
    ref, q = one.infer(image, settings)
    return model, params, image, settings, ref, q


def _shard_run(strip, devices):
    _, params, image, settings, _, _ = strip
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
    *_, ref, ref_q = strip
    got, q = two_shards if devices == ["cpu"] * 2 else _shard_run(strip, devices)
    assert int(ref.valid.sum()) > 0
    assert torch.equal(q, ref_q)
    for name, a, b in zip(InstanceSet._fields, got, ref):
        assert torch.equal(a, b), name


def test_two_shard_engine_matches_jax(strip, two_shards):
    model, params, image, _, _, _ = strip
    ref, ref_q = jax_engine.TileEngine(model, params, **KW).infer(
        image, jax_engine.class_settings_from_config(SETTINGS, 2))
    got, q = two_shards
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    assert got.capacity == ref.capacity and int(np.asarray(ref.valid).sum()) > 0
    _assert_sets_match(got, ref, box_atol=1e-3)


def test_replicas_only_where_a_block_runs(strip):
    """A grid of fewer chunks than devices (one chunk of all 12 tiles) runs
    on the first device alone: no replica is made for the second, and the
    result is the one-device engine's."""
    _, params, image, settings, _, _ = strip
    kw = {**KW, "tile_batch": 16}
    one = pt_engine.TileEngine(port_model(params), device="cpu", **kw).infer(image, settings)
    eng = pt_engine.TileEngine(port_model(params), device=["cpu", "cpu:0"], **kw)
    got = eng.infer(image, settings)
    assert list(eng.replicas) == [torch.device("cpu")]
    assert torch.equal(got[1], one[1])
    for name, a, b in zip(InstanceSet._fields, got[0], one[0]):
        assert torch.equal(a, b), name


class _Fixed:
    """An ensemble member returning one set, from whatever thread."""

    def __init__(self, seed, fail=False):
        self.capacity, self.device, self.fail = 48, torch.device("cpu"), fail
        self.result = InstanceSet(*(torch.from_numpy(np.asarray(a)) for a in _instances(seed))), torch.tensor(0.5 + seed)

    def infer(self, image, settings, upscale=None):
        if self.fail:
            raise RuntimeError("member failed")
        return self.result


@pytest.mark.parametrize("fail", [None, 0, 1])
def test_members_at_once_equal_members_in_turn(fail):
    members = [(name, _Fixed(seed, fail=i == fail), w) for i, (name, seed, w) in
               enumerate((("R101", 11, 0.4), ("R50", 12, 0.6)))]
    ref = pt_ens.run_ensemble(members, None, None, (140, 140), secondary_class_filter={1})
    got = pt_ens.run_ensemble(members, None, None, (140, 140), secondary_class_filter={1}, parallel=True)
    assert got[2] == ref[2] == [n for i, (n, _, _) in enumerate(members) if i != fail]
    assert torch.equal(got[1], ref[1])
    for name, a, b in zip(InstanceSet._fields, got[0], ref[0]):
        assert torch.equal(a, b), name


def test_member_parallel_pipeline_equals_members_in_turn(golden):
    """The ensemble pipeline on 2 CPU devices (``inference_chips: 2``): R101
    and R50 on a one-device group each, run at once, write the CSVs of the
    one-device pipeline, which runs them in turn."""
    from deepemia_tpu.models.mask_rcnn import build_model as jax_build_model
    from deepemia_tpu.models.mask_rcnn import init_params

    params = init_params(jax_build_model("R50", num_classes=2, use_bf16=False), (64, 64), seed=1)
    _write_checkpoint(Path(golden["split_dir"]) / "zds" / "rcnn_r101" / "model_final_r101.pkl",
                      _zoo_state_dict(params))
    cfg = golden["cfg"]
    out = {}
    for chips in (1, 2):
        c = {**cfg, "performance": {**cfg["performance"], "inference_chips": chips},
             "inference_settings": {**cfg["inference_settings"],
                                    "ensemble_settings": {"enabled": True, "small_classes_only": True}}}
        pipe = InferencePipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / f"chips{chips}"),
                                 config=c, use_bf16=False, default_threshold=0.2, device="cpu")
        assert pipe.member_parallel == (chips == 2) and pipe.use_ensemble
        assert [e.devices for _, e, _ in pipe.engines] == [[torch.device("cpu")]] * 2
        res = pipe.run(golden["inf_dir"], visualize=False)
        assert res["processed"] == ["micro.png"] and res["members"] == {"micro.png": ["R101", "R50"]}
        out[chips] = [Path(res[k]).read_bytes() for k in ("measurements_csv", "rle_csv")]
    assert out[1] == out[2] and len(out[1][0].splitlines()) > 1


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
