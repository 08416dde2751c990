"""Port parity: training target assignment (anchor / proposal matching and
subsampling) against the JAX package's ``train/targets.py``, exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.train import targets as jax_t
from deepemia_tpu_torch.train import targets as pt_t

torch.set_num_threads(2)


def _boxes(rng, n, extent=128.0, lo=2.0, hi=60.0):
    xy = rng.uniform(-10, extent, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _cases():
    rng = np.random.default_rng(3)
    anchors = _boxes(rng, 400)
    gt = _boxes(rng, 6, lo=10, hi=50)
    # ties: a duplicated anchor and a duplicated GT row
    anchors[7] = anchors[3]
    gt[4] = gt[1]
    # an anchor equal to a GT box (IoU 1)
    anchors[11] = gt[0]
    valid = np.array([True, True, False, True, True, False])
    return {
        "some_valid": (anchors, gt, valid),
        "all_valid": (anchors, gt, np.ones(6, bool)),
        "none_valid": (anchors, gt, np.zeros(6, bool)),
        "far_gt": (anchors, gt + 1000.0, valid),  # low-quality only: IoU 0 everywhere
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_match_anchors_matches_jax(case):
    anchors, gt, valid = _cases()[case]
    ref = jax_t.match_anchors(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid))
    got = pt_t.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.gt_index.numpy(), np.asarray(ref.gt_index))
    if case == "some_valid":
        labels = np.asarray(ref.labels)
        assert (labels == 1).any() and (labels == 0).any() and (labels == -1).any()
    if case == "none_valid":
        assert (got.labels.numpy() == 0).all()


@pytest.mark.parametrize("case", sorted(_cases()))
def test_match_proposals_matches_jax(case):
    props, gt, valid = _cases()[case]
    ref = jax_t.match_proposals(jnp.asarray(props), jnp.asarray(gt), jnp.asarray(valid))
    got = pt_t.match_proposals(torch.from_numpy(props), torch.from_numpy(gt), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.gt_index.numpy(), np.asarray(ref.gt_index))


def _jax_draws(key, n):
    """The priorities the JAX ``subsample`` draws from ``key``."""
    r_pos, r_neg = jax.random.split(key)
    return np.array(jax.random.uniform(r_pos, (n,))), np.array(jax.random.uniform(r_neg, (n,)))


@pytest.mark.parametrize(
    "n_pos, n_neg, num, frac, extra",
    [
        (300, 600, 256, 0.5, False),  # enough of both
        (5, 600, 256, 0.5, False),  # scarce positives: slots stay invalid
        (40, 30, 64, 0.25, True),  # scarce negatives, extra validity mask
        (0, 0, 32, 0.5, False),  # nothing to draw
    ],
)
def test_subsample_matches_jax_with_injected_draws(n_pos, n_neg, num, frac, extra):
    rng = np.random.default_rng(n_pos + n_neg)
    n = 1000
    labels = np.full(n, -1, np.int32)
    perm = rng.permutation(n)
    labels[perm[:n_pos]] = 1
    labels[perm[n_pos : n_pos + n_neg]] = 0
    ok = rng.random(n) > 0.3 if extra else None
    key = jax.random.PRNGKey(n_pos)
    ref = jax_t.subsample(
        jnp.asarray(labels), key, num, frac, extra_valid=None if ok is None else jnp.asarray(ok)
    )
    pos_rand, neg_rand = _jax_draws(key, n)
    got = pt_t.subsample(
        torch.from_numpy(labels), num, frac,
        extra_valid=None if ok is None else torch.from_numpy(ok),
        pos_rand=torch.from_numpy(pos_rand), neg_rand=torch.from_numpy(neg_rand),
    )
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.is_pos.numpy(), np.asarray(ref.is_pos))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_subsample_generator_draws_are_seeded_and_well_formed():
    """Without injected draws the priorities come from the generator: one
    seed gives one sample, positives fill only the positive slots."""
    labels = torch.from_numpy(np.random.default_rng(0).integers(-1, 2, 500))
    a = pt_t.subsample(labels, 128, 0.25, generator=torch.Generator().manual_seed(5))
    b = pt_t.subsample(labels, 128, 0.25, generator=torch.Generator().manual_seed(5))
    c = pt_t.subsample(labels, 128, 0.25, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.idx, b.idx) and not torch.equal(a.idx, c.idx)
    assert (labels[a.idx[a.is_pos & a.valid]] == 1).all()
    assert (labels[a.idx[~a.is_pos & a.valid]] == 0).all()
    assert int(a.is_pos.sum()) == 32 and len(set(a.idx[a.valid].tolist())) == int(a.valid.sum())
