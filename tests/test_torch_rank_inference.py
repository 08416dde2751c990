"""Port parity: ``--task inference`` across the ranks of a process group, on
the CPU. The devices a rank owns under a launcher; the global tile-device
list against the JAX pipeline's ``_choose_inference_mesh`` and the member
groups against ``_member_meshes`` with two processes; the tile engine on
two gloo ranks of two CPU shards each (uneven blocks, and a rank with no
block by ``inference_chips``): every rank's set the one-device engine's,
bit for bit, and the JAX engine's at ``test_torch_engine``'s limits, and a
failing block raised on every rank; the CLI in two ranks started as
``torchrun`` starts them: the CSVs of one process byte for byte, written by
rank 0 alone, an image one rank cannot read skipped by both, image lists
that differ refused by name on both; ``--task prepare`` run by rank 0
alone while rank 1 waits and exits 0.

Ranks are spawned processes (``test_torch_tensor_parallel.run_ranks``:
one torch thread each, joined with a deadline)."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.inference.pipeline import InferencePipeline
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.parallel import mesh as pt_mesh
from deepemia_tpu_torch.parallel import ranks as rank_ops
from test_torch_tensor_parallel import run_ranks
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)

CUDA = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("local_world, owned", [
    (1, [CUDA]),  # one process a host: every GPU
    (4, [[d] for d in CUDA]),  # one process a GPU
    (2, [CUDA[:2], CUDA[2:]]),
    (3, [CUDA[:2], CUDA[2:3], CUDA[3:]]),
    (6, [[d] for d in CUDA] + [[], []]),  # more processes than GPUs
])
def test_a_rank_owns_its_block_of_the_host(local_world, owned):
    assert [pt_mesh.owned_devices(CUDA, r, local_world) for r in range(local_world)] == owned


def _every_rank(n_ranks, per_rank=4):
    return [(r, d) for r in range(n_ranks) for d in CUDA[:per_rank]]


@pytest.mark.parametrize("chips", [0, 1, 2, 3, 5, 8, 9])
def test_global_tile_devices_follow_the_jax_inference_mesh(chips, monkeypatch):
    """Two ranks of four GPUs each: the first ``inference_chips`` (0 = all)
    of the eight, in rank order, as many as the JAX ``_choose_inference_mesh``
    puts in its mesh over its eight (one where it returns None, each process
    alone: the port's second rank then takes no block)."""
    import jax

    from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline

    assert len(jax.devices()) == 8
    every = _every_rank(2)
    monkeypatch.setattr(rank_ops, "rank_world", lambda: (1, 2))
    monkeypatch.setattr(pt_mesh, "local_devices", lambda: CUDA)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    seen = []
    monkeypatch.setattr(pt_mesh, "global_devices", lambda mine: seen.append(mine) or every)
    ref = JaxPipeline._choose_inference_mesh({"inference_chips": chips})
    got = InferencePipeline._choose_tile_devices({"inference_chips": chips}, torch.device("cuda"))
    assert seen == [CUDA]
    assert got == every[: 1 if ref is None else ref.devices.size]


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
@pytest.mark.parametrize("n_members", [1, 2, 3])
@pytest.mark.parametrize("enabled", [True, False])
def test_members_share_the_devices_in_a_group(n_devices, n_members, enabled, monkeypatch):
    """With two processes the JAX ``_member_meshes`` gives every member the
    whole mesh, whatever the devices; the port's members then share the
    global device list (``_member_groups`` is None) and run in turn."""
    import jax

    from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline
    from deepemia_tpu.parallel import mesh as jax_mesh

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(rank_ops, "rank_world", lambda: (0, 2))
    mesh = jax_mesh.tile_mesh(n_devices) if n_devices > 1 else None
    ref = JaxPipeline._member_meshes(mesh, n_members, enabled)
    assert all(m is mesh for m in ref)
    assert InferencePipeline._member_groups(_every_rank(2)[:n_devices], n_members, enabled) is None


def test_exchange_packs_instances_exactly():
    from tests.test_torch_engine import _instances

    inst = InstanceSet(*(torch.from_numpy(np.asarray(a)) for a in _instances(3)))
    back = pt_engine.unpack_instances(pt_engine.pack_instances(inst))
    for name, a, b in zip(InstanceSet._fields, back, inst):
        assert a.dtype == b.dtype and torch.equal(a, b), name


# 64x160 in 64 px tiles: 6 tiles, a chunk each; over 4 devices (2 + 2
# ranks) blocks of 2, 2, 1 and 1 chunks; over 1 (rank 0's first) all 6,
# on no shard thread, and none on rank 1
KW = dict(tile_size=64, tile_batch=1, upscale_factor=1.0, full_pass_max_dim=0, confidence_mode="auto")
SETTINGS = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
CHIPS = (4, 1)
# the (start, stop) tile chunks each rank runs, by inference_chips
CHUNKS_RUN = {4: ([(0, 1), (1, 2), (2, 3), (3, 4)], [(4, 5), (5, 6)]), 1: ([(i, i + 1) for i in range(6)], [])}


def _image():
    return (np.random.default_rng(8).random((64, 160, 3)) * 255).astype(np.uint8)


def _model(state_path):
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    model.load_state_dict(torch.load(state_path, map_location="cpu"))
    return model


def _engine_rank(rank, world, state_path, out):
    """Each rank owns two CPU shards; for each ``inference_chips`` the engine
    on that cut of the global list (with the chunks this rank ran); then a
    whole-image pass (on rank 0) with rank 1's part failing."""
    every = pt_mesh.global_devices([torch.device("cpu")] * 2)
    settings = pt_engine.class_settings_from_config(SETTINGS, 2)
    ran, real = [], pt_engine.TileEngine._run_chunks

    def run_chunks(self, device, chunks, *a):
        ran.extend(chunks)
        return real(self, device, chunks, *a)

    pt_engine.TileEngine._run_chunks = run_chunks
    results = {}
    for chips in CHIPS:
        engine = pt_engine.TileEngine(_model(state_path), device=pt_mesh.tile_devices(chips, every), **KW)
        inst, q = engine.infer(_image(), settings)
        results[chips] = ([t.clone() for t in inst], q.clone(), engine.lead, sorted(ran))
        ran.clear()
    engine = pt_engine.TileEngine(_model(state_path), device=every, **{**KW, "use_tiling": False})
    if rank == 1:
        def fail(*a, **kw):
            raise ValueError("a planted fault")

        pt_engine.image_quality_score = fail
    try:
        engine.infer(_image()[:, :64], settings)
        results["failure"] = None
    except RuntimeError as e:
        results["failure"] = (str(e), repr(e.__cause__))
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def sane_state(tiny_r50, tmp_path_factory):
    from tests.test_torch_heads import port_model, sane_geometry

    params = sane_geometry(tiny_r50[1])
    path = tmp_path_factory.mktemp("rank_engine") / "state.pt"
    torch.save(port_model(params).state_dict(), path)
    yield params, str(path)
    os.remove(path)


def test_ranks_serve_as_one_device(tiny_r50, sane_state, tmp_path):
    """Two gloo ranks of two CPU shards each: on every rank, at every cut of
    the four devices, the one-device engine's set and quality bit for bit
    (same thread count) and the JAX engine's set at ``test_torch_engine``'s
    limits; the lead the rank of the first device; each rank ran the
    chunks of its own devices' blocks (none on rank 1 when the cut leaves
    it no device: with random weights the scores tie at 1.0, so a rank
    that ran the grid again would not show in the set). Rank 1's part of an
    image failing fails it on both ranks, rank 1's error chained to its
    own."""
    import jax

    from deepemia_tpu.inference import engine as jax_engine
    from tests.test_torch_engine import _assert_sets_match

    params, path = sane_state
    run_ranks(_engine_rank, 2, path, str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref, ref_q = pt_engine.TileEngine(_model(path), device="cpu", **KW).infer(
            _image(), pt_engine.class_settings_from_config(SETTINGS, 2))
    finally:
        torch.set_num_threads(threads)
    jref, jq = jax_engine.TileEngine(tiny_r50[0], params, **KW).infer(
        _image(), jax_engine.class_settings_from_config(SETTINGS, 2))
    jax.block_until_ready(jref)
    assert int(ref.valid.sum()) > 0
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for chips in CHIPS:
            inst, q, lead, ran = got[chips]
            assert lead == (rank == 0)
            assert ran == CHUNKS_RUN[chips][rank], (rank, chips, ran)
            assert torch.equal(q, ref_q)
            for name, a, b in zip(InstanceSet._fields, inst, ref):
                assert torch.equal(a, b), (rank, chips, name)
            np.testing.assert_allclose(float(q), float(jq), rtol=1e-5)
            _assert_sets_match(InstanceSet(*inst), jref, box_atol=1e-3)
        message, cause = got["failure"]
        assert "failed on rank(s) [1] of 2" in message
        assert ("a planted fault" in cause) == (rank == 1)


# the CLI in two ranks: 128² micrographs, one whole-image pass each on rank
# 0 (the tile blocks across ranks are test_ranks_serve_as_one_device's)
FLAGS = ["--task", "inference", "--dataset_name", "zds", "--threshold", "0.2", "--visualize", "--no-download",
         "--no-upload", "--device", "cpu"]
OUTPUTS = ("measurements_results.csv", "R50_flip_results.csv")


def _home(root: Path, sd, images) -> Path:
    """``test_torch_cli.make_home`` (no tiles, the size heuristic on) with
    ``images`` (name -> bytes) in DATASET/INFERENCE."""
    from tests.test_torch_cli import make_home

    home = make_home(root, sd)
    folder = home / "DATASET" / "INFERENCE"
    for p in folder.iterdir():
        p.unlink()
    for name, data in images.items():
        (folder / name).write_bytes(data)
    return home


def _micrographs():
    import cv2

    out = {}
    for i in range(3):
        im = np.full((128, 128, 3), 30 + 10 * i, np.uint8)
        cv2.circle(im, (40 + 10 * i, 50), 16 - 2 * i, (220, 220, 220), -1)
        cv2.circle(im, (90, 80 - 5 * i), 10, (180, 180, 180), -1)
        ok, buf = cv2.imencode(".tif", im)
        out[f"micro_{i}.tif"] = buf.tobytes()
    return out


def _cli_rank(rank, world, homes, out):
    """The CLI on the rank's own home, as a launcher's rank: first the homes
    whose image lists differ (``PipelineError`` expected), then the run."""
    import deepemia_tpu_torch.config.config as port_cfg
    from deepemia_tpu_torch.cli import main as cli
    from deepemia_tpu_torch.utils.exceptions import PipelineError

    report = {}
    for run, by_rank in homes.items():
        os.environ["DEEPEMIA_TPU_HOME"] = by_rank[rank]
        port_cfg._default_store = None
        try:
            report[run] = cli.run_task(cli.build_parser().parse_args(FLAGS))
        except PipelineError as e:
            report[run] = str(e)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def test_cli_ranks_write_the_one_process_csvs(tiny_r50, tmp_path):
    """``--task inference`` in two gloo ranks started as ``torchrun`` starts
    them. Image lists that differ (rank 1 holds one more file) fail on both
    ranks, naming it. Then micro_1.tif is corrupt on rank 1 alone: both
    ranks skip it (in the size heuristic's sample too), rank 0 writes the CSVs of one process on micro_0 and
    micro_2 byte for byte, and rank 1 writes no result and no ETA."""
    from tests.test_torch_pipeline import _zoo_state_dict

    sd = _zoo_state_dict(tiny_r50[1])
    images = _micrographs()
    broken = {**images, "micro_1.tif": images["micro_1.tif"][:200]}
    homes = {
        "ref": _home(tmp_path / "ref", sd, {k: v for k, v in images.items() if k != "micro_1.tif"}),
        "r0": _home(tmp_path / "r0", sd, images),
        "r1": _home(tmp_path / "r1", sd, broken),
        "extra": _home(tmp_path / "extra", sd, {**images, "micro_3.tif": images["micro_0.tif"]}),
    }
    homes = {k: str(v) for k, v in homes.items()}
    run_ranks(_cli_rank, 1, {"ref": [homes["ref"]]}, str(tmp_path / "ref"))
    run_ranks(_cli_rank, 2, {"lists": [homes["r0"], homes["extra"]], "run": [homes["r0"], homes["r1"]]},
              str(tmp_path), launcher=True)
    assert json.loads((tmp_path / "ref" / "rank0.json").read_text()) == {"ref": 0}
    for rank in range(2):
        report = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert "do not agree on the sorted image list" in report["lists"] and "'micro_3.tif'" in report["lists"]
        assert report["run"] == 1  # micro_1.tif failed
    ref, got = (Path(homes[k]) / "output" for k in ("ref", "r0"))
    for name in OUTPUTS:
        assert (got / name).read_bytes() == (ref / name).read_bytes(), name
    rows = (got / "measurements_results.csv").read_text().splitlines()
    assert len(rows) > 1 and {r.rsplit(",", 1)[-1] for r in rows[1:]} == {"micro_0.tif", "micro_2.tif"}
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in ref.iterdir())
    # the config store makes the output folder on every rank (as the JAX package's does); rank 1 fills nothing
    assert not list((Path(homes["r1"]) / "output").rglob("*"))
    assert not (Path(homes["r1"]) / "config" / "eta_data.json").exists()
    assert (Path(homes["r0"]) / "config" / "eta_data.json").exists()
    shutil.rmtree(tmp_path / "extra", ignore_errors=True)


def _prepare_rank(rank, world, homes, out):
    """``--task prepare`` on the rank's own home, as a launcher's rank."""
    import deepemia_tpu_torch.config.config as port_cfg
    from deepemia_tpu_torch.cli import main as cli

    os.environ["DEEPEMIA_TPU_HOME"] = homes[rank]
    port_cfg._default_store = None
    rc = cli.run_task(cli.build_parser().parse_args(
        ["--task", "prepare", "--dataset_name", "zds", "--no-download", "--no-upload", "--device", "cpu"]))
    with open(os.path.join(out, f"prepare{rank}.json"), "w") as f:
        json.dump(rc, f)


def test_prepare_runs_on_rank_0_alone(tmp_path):
    """``--task prepare`` in two launcher ranks: rank 0 writes the split
    file and the ETA, rank 1 waits at the barrier and exits 0 having
    written neither."""
    import yaml

    from deepemia_tpu_torch.config.config import default_config
    from test_torch_datasets import make_dataset

    homes = []
    for r in range(2):
        home = tmp_path / f"home{r}"
        cfg = default_config(home)
        (home / "config").mkdir(parents=True)
        (home / "config" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
        root = make_dataset(home / "DATASET" / "zds", 3, seed=12, size=(64, 64), classes=("particle", "pore"))
        (home / "dataset_info.json").write_text(json.dumps({"zds": [root, root, ["particle", "pore"]]}))
        homes.append(str(home))
    run_ranks(_prepare_rank, 2, homes, str(tmp_path), launcher=True)
    assert [json.loads((tmp_path / f"prepare{r}.json").read_text()) for r in range(2)] == [0, 0]
    assert (tmp_path / "home0" / "split_dir" / "zds_split.json").exists()
    assert (tmp_path / "home0" / "config" / "eta_data.json").exists()
    assert not (tmp_path / "home1" / "split_dir" / "zds_split.json").exists()
    assert not (tmp_path / "home1" / "config" / "eta_data.json").exists()
