"""The port's colour helpers (``deepemia_tpu_torch/utils/color.py``)
against the JAX package's on a seeded RGB grid: the half-degree hue,
saturation and value, the hue-to-wavelength map, and its refusals."""

import numpy as np
import pytest
import torch

from deepemia_tpu.utils import color as jax_color
from deepemia_tpu_torch.utils import color as port_color

torch.set_num_threads(1)


def _grid(seed):
    rng = np.random.default_rng(seed)
    corners = [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255), (7, 7, 7), (255, 255, 0)]
    return corners + [tuple(int(v) for v in c) for c in rng.integers(0, 256, (400, 3))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rgb_to_hsv_matches_jax(seed):
    for r, g, b in _grid(seed):
        assert port_color.rgb_to_hsv(r, g, b) == jax_color.rgb_to_hsv(r, g, b), (r, g, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_rgb_to_wavelength_matches_jax(seed):
    for r, g, b in _grid(seed):
        try:
            want = jax_color.rgb_to_wavelength(r, g, b)
        except ValueError as e:  # a hue past 270 degrees of the half-degree scale: both refuse
            with pytest.raises(ValueError, match=str(e)):
                port_color.rgb_to_wavelength(r, g, b)
            continue
        assert port_color.rgb_to_wavelength(r, g, b) == want, (r, g, b)


@pytest.mark.parametrize("hue", [0.0, 45.5, 135.0, 270.0, -0.5, 270.5, 400.0])
def test_hue_to_wavelength_matches_jax(hue):
    if 0 <= hue <= 270:
        assert port_color.hue_to_wavelength(hue) == jax_color.hue_to_wavelength(hue)
        return
    for mod in (jax_color, port_color):
        with pytest.raises(ValueError, match="hue must be in"):
            mod.hue_to_wavelength(hue)
