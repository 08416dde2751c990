"""Port parity of run-length encoding: the host encoder and decoder, and the
device encoders (full-image batch and windowed), including masks over the
run capacity, against the JAX package. Integers: equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepemia_tpu.ops import rle as jax_rle
from deepemia_tpu_torch.ops import rle as pt_rle

torch.set_num_threads(2)


def _masks(seed, n=6, h=37, w=29):
    rng = np.random.default_rng(seed)
    m = rng.random((n, h, w)) > 0.6
    m[0] = False  # empty
    m[1] = True  # one run over the whole image
    m[2, 3:20, 4:9] = True
    m[2, :3] = False
    return m


def test_host_encoder_matches_jax_and_round_trips():
    for i, m in enumerate(_masks(0)):
        got = pt_rle.rle_encode(m)
        assert got == jax_rle.rle_encode(m)
        assert pt_rle.rle_to_string(got) == jax_rle.rle_to_string(got)
        np.testing.assert_array_equal(pt_rle.rle_decode(got, m.shape), m)
        np.testing.assert_array_equal(pt_rle.rle_decode(got, m.shape), jax_rle.rle_decode(got, m.shape))


def test_crop_encoder_matches_the_whole_image():
    """``rle_encode_crop`` of a mask's bounding box at its origin equals the
    JAX package's ``rle_encode`` of the whole mask, runs across a column's
    end (boxes over the full height) included."""
    rng = np.random.default_rng(1)
    masks = list(_masks(3)) + [np.zeros((37, 29), bool) for _ in range(20)]
    for m in masks[6:]:
        y0, x0 = rng.integers(0, 37), rng.integers(0, 29)
        y1, x1 = rng.integers(y0 + 1, 38), rng.integers(x0 + 1, 30)
        m[y0:y1, x0:x1] = rng.random((y1 - y0, x1 - x0)) < rng.choice([0.3, 1.0])
    for m in masks:
        ys, xs = np.nonzero(m)
        if ys.size == 0:
            assert pt_rle.rle_encode_crop(np.zeros((0, 0), bool), (0, 0), 37) == []
            continue
        crop = m[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
        assert pt_rle.rle_encode_crop(crop, (xs.min(), ys.min()), m.shape[0]) == jax_rle.rle_encode(m)


@pytest.mark.parametrize("max_runs", [4096, 40, 7])
def test_batch_encoder_matches_jax(max_runs):
    """Capacities above, near and far below the masks' run counts: a mask
    over capacity reports n_runs = max_runs and its first max_runs runs."""
    m = _masks(1)
    ref = jax_rle.rle_encode_batch_jax(jnp.asarray(m), max_runs=max_runs)
    got = pt_rle.rle_encode_batch(torch.from_numpy(m), max_runs=max_runs)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    n = got[2].numpy()
    assert (n == max_runs).any() == (max_runs < 400)
    for i in np.flatnonzero(n < max_runs):
        pairs = np.empty(2 * n[i], np.int64)
        pairs[0::2], pairs[1::2] = got[0][i, : n[i]].numpy(), got[1][i, : n[i]].numpy()
        assert pairs.tolist() == pt_rle.rle_encode(m[i])


@pytest.mark.parametrize("window", [24, 64])
def test_windowed_encoder_matches_jax(window):
    """Instances inside and over the window (the latter report max_runs),
    at the image border and invalid."""
    rng = np.random.default_rng(2)
    k, h, w = 10, 80, 70
    xy = rng.random((k, 2)) * 60
    boxes = np.concatenate([xy, xy + 3 + rng.random((k, 2)) * 30], 1).astype(np.float32)
    boxes[0] = [0.0, 0.0, 9.5, 12.25]
    boxes[1] = [50.0, 60.0, 69.9, 79.9]
    probs = rng.random((k, 28, 28)).astype(np.float32)
    valid = rng.random(k) > 0.2
    valid[:2] = True
    for max_runs in (512, 6):
        ref = jax_rle.rle_encode_windowed_jax(
            jnp.asarray(probs), jnp.asarray(boxes), jnp.asarray(valid), (h, w),
            max_runs=max_runs, threshold=0.5, window=window,
        )
        got = pt_rle.rle_encode_windowed(
            torch.from_numpy(probs), torch.from_numpy(boxes), torch.from_numpy(valid), (h, w),
            max_runs=max_runs, threshold=0.5, window=window,
        )
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[2].numpy() == 6).any() and (got[2].numpy() == 0).any()
