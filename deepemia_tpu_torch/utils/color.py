"""Colour -> wavelength helpers (a copy of the JAX package's
``utils/color.py``).

``rgb_to_hsv`` keeps OpenCV's half-degree hue (0-180); ``hue_to_wavelength``
maps a hue in degrees linearly from 620 nm (0) to 450 nm (270). The
pipeline does not call them; they serve analyses downstream of the CSVs.
"""

from __future__ import annotations

from typing import Tuple


def rgb_to_hsv(r: float, g: float, b: float) -> Tuple[float, float, float]:
    """RGB (0-255) -> (h in 0-180, s in 0-255, v in 0-255): OpenCV's
    half-degree hue convention."""
    rf, gf, bf = r / 255.0, g / 255.0, b / 255.0
    mx, mn = max(rf, gf, bf), min(rf, gf, bf)
    v = mx
    if mx == 0.0 or mx == mn:
        return 0.0, 0.0, v * 255.0
    s = (mx - mn) / mx
    if mx == rf:
        h = 60.0 * (gf - bf) / (mx - mn)
    elif mx == gf:
        h = 60.0 * (bf - rf) / (mx - mn) + 120.0
    else:
        h = 60.0 * (rf - gf) / (mx - mn) + 240.0
    if h < 0:
        h += 360.0
    return h / 2.0, s * 255.0, v * 255.0


def hue_to_wavelength(hue: float) -> float:
    """Hue (0-270 degrees) -> approximate wavelength in nm: the linear map
    620..450 nm."""
    if not 0 <= hue <= 270:
        raise ValueError(f"hue must be in [0, 270], got {hue}")
    return 620.0 - 170.0 / 270.0 * hue


def rgb_to_wavelength(r: float, g: float, b: float) -> float:
    """RGB -> dominant wavelength in nm, through the half-degree hue."""
    h, _, _ = rgb_to_hsv(r, g, b)
    return hue_to_wavelength(h)
