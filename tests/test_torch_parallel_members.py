"""Port parity: the parallel axes on the CPU, the tests that build their
own engines (apart from ``test_torch_parallel.py``'s module-scoped strips,
so that a test worker of their own runs them): a tile engine given more
devices than it has blocks makes a replica only where a block runs; the
ensemble's members run at once equal the members in turn, alone and in
the pipeline on 2 CPU devices."""

from pathlib import Path

import numpy as np
import pytest
import torch

from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.inference import ensemble as pt_ens
from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.inference.pipeline import InferencePipeline
from tests.test_torch_engine import _instances
from tests.test_torch_heads import port_model, sane_geometry
from tests.test_torch_parallel import KW, SETTINGS
from tests.test_torch_pipeline import _write_checkpoint, _zoo_state_dict, golden  # noqa: F401 - golden: a fixture
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)


def test_replicas_only_where_a_block_runs(tiny_r50):
    """A grid of fewer chunks than devices (one chunk of all 12 tiles of the
    64x288 strip) runs on the first device alone: no replica is made for
    the second, and the result is the one-device engine's."""
    params = sane_geometry(tiny_r50[1])
    image = (np.random.default_rng(8).random((64, 288, 3)) * 255).astype(np.uint8)
    settings = pt_engine.class_settings_from_config(SETTINGS, 2)
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
