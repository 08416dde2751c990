"""Port parity of the ensemble: the JAX package's ``run_ensemble`` and the
port's on the same two members' weights (carried across with
``params_from_jax``), on a 128² image through the engine's whole-image pass
(the tiled pass is held to the JAX package in tests/test_torch_engine.py),
f32 on the CPU. The merged set's valid rows must match to the tolerances of
tests/test_torch_engine.py, with the member weights on and off and the
small-classes gate on and off.

The two members are R50 networks initialised from different seeds and named
"R101" and "R50": the ensemble's code path does not depend on the depth,
and a JAX R101 compile would make this file several times slower. The
R101 network itself is held to the JAX package in tests/test_torch_r101.py.
"""

import numpy as np
import pytest
import torch

from deepemia_tpu.inference import ensemble as jax_ens
from deepemia_tpu.inference import engine as jax_engine
from deepemia_tpu.models.mask_rcnn import init_params
from deepemia_tpu_torch.inference import ensemble as pt_ens
from deepemia_tpu_torch.inference import engine as pt_engine
from tests.test_torch_engine import _assert_sets_match
from tests.test_torch_heads import port_model, sane_geometry

torch.set_num_threads(2)

KW = dict(use_tiling=False, confidence_mode="auto")
SETTINGS = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}, "class_1": {"confidence_threshold": 0.3}}}
HW = (128, 128)


@pytest.fixture(scope="module")
def members(tiny_r50):
    """[(name, JAX engine, port engine)] for "R101" (seed 0) and "R50" (seed 1)."""
    model, params0 = tiny_r50
    params1 = init_params(model, (64, 64), seed=1)
    out = []
    for name, params in (("R101", params0), ("R50", params1)):
        p = sane_geometry(params)
        out.append((name, jax_engine.TileEngine(model, p, **KW), pt_engine.TileEngine(port_model(p), device="cpu", **KW)))
    return out


@pytest.fixture(scope="module")
def image():
    return (np.random.default_rng(5).random((128, 128, 3)) * 255).astype(np.uint8)


class _Recorder:
    """Wraps an engine; keeps its ``infer`` results for replay."""

    def __init__(self, engine):
        self.engine, self.capacity, self.device, self.results = engine, engine.capacity, getattr(engine, "device", None), []

    def infer(self, image, settings, upscale=None):
        self.results.append(self.engine.infer(image, settings, upscale=upscale))
        return self.results[-1]


class _Replay:
    """An engine that returns one precomputed ``infer`` result."""

    def __init__(self, recorder):
        self.capacity, self.device, self._result = recorder.capacity, recorder.device, recorder.results[0]

    def infer(self, image, settings, upscale=None):
        return self._result


@pytest.fixture(scope="module")
def through_engines(members, image):
    """Both frameworks' ``run_ensemble`` through the real engines (small
    classes gate on), with every member's engine output recorded."""
    weights = pt_ens.weights_from_config({})
    jax_rec = [(n, _Recorder(je), weights[n]) for n, je, _ in members]
    pt_rec = [(n, _Recorder(pe), weights[n]) for n, _, pe in members]
    ref = jax_ens.run_ensemble(jax_rec, image, jax_engine.class_settings_from_config(SETTINGS, 2), HW, secondary_class_filter={1})
    got = pt_ens.run_ensemble(pt_rec, image, pt_engine.class_settings_from_config(SETTINGS, 2), HW, secondary_class_filter={1})
    return ref, got, jax_rec, pt_rec


@pytest.fixture(scope="module")
def replays(through_engines):
    """Each member's recorded engine output, per framework."""
    _, _, jax_rec, pt_rec = through_engines
    return [(n, _Replay(r), w) for n, r, w in jax_rec], [(n, _Replay(r), w) for n, r, w in pt_rec]


def test_weights_from_config_match():
    for inf in ({}, {"ensemble_settings": {}}, {"ensemble_settings": {"weights": {"R50": 0.9}}},
                {"ensemble_settings": {"weights": {"R50": 1, "R101": 2.5}}}, {"ensemble_settings": {"weights": None}}):
        assert pt_ens.weights_from_config(inf) == jax_ens.weights_from_config(inf)


def test_ensemble_matches_jax_through_the_engines(through_engines):
    (ref, ref_q), (got, q, ran), _, _ = through_engines
    assert ran == ["R101", "R50"]
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    assert got.capacity == ref.capacity and int(np.asarray(ref.valid).sum()) > 0
    _assert_sets_match(got, ref, box_atol=1e-3)


@pytest.mark.parametrize("apply_weights", [True, False])
@pytest.mark.parametrize("class_filter", [None, {1}, set()])
def test_ensemble_merge_matches_jax(replays, apply_weights, class_filter):
    jax_members, pt_members = replays
    ref, _ = jax_ens.run_ensemble(
        jax_members, None, None, HW, apply_weights=apply_weights, secondary_class_filter=class_filter
    )
    got, _, ran = pt_ens.run_ensemble(
        pt_members, None, None, HW, apply_weights=apply_weights, secondary_class_filter=class_filter
    )
    assert ran == ["R101", "R50"]
    assert int(np.asarray(ref.valid).sum()) > 0
    _assert_sets_match(got, ref, box_atol=1e-3)
    if class_filter is not None:
        # rows of the classes outside the gate come from the primary member alone
        first = pt_members[0][1]._result[0]
        primary = first.boxes.numpy()[first.valid.numpy()]
        outside = got.valid.numpy() & ~np.isin(got.classes.numpy(), sorted(class_filter))
        assert all((np.abs(primary - b).max(1) == 0).any() for b in got.boxes.numpy()[outside])


class _Failing:
    capacity, device = 100, torch.device("cpu")

    def infer(self, image, settings, upscale=None):
        raise RuntimeError("member failed")


def test_failing_member_is_skipped_and_reported(replays):
    _, pt_members = replays
    only_r50, _, ran = pt_ens.run_ensemble([("R101", _Failing(), 0.4), pt_members[1]], None, None, HW)
    assert ran == ["R50"]
    alone, _, _ = pt_ens.run_ensemble([pt_members[1]], None, None, HW)
    np.testing.assert_array_equal(only_r50.valid.numpy(), alone.valid.numpy())
    empty, _, ran = pt_ens.run_ensemble([("R101", _Failing(), 0.4), ("R50", _Failing(), 0.6)], None, None, HW)
    assert ran == [] and not empty.valid.any() and empty.capacity == 100
