"""Contour-free shape measurements of binary masks, as torch ops.

The port of the JAX package's on-device morphometrics (the measurement
backend ``device``):

  * area: the pixel count with a Pick's-theorem boundary correction, so it
    tracks the polygon area of the traced contour;
  * perimeter: the digital 8-contour length from the axial and diagonal
    adjacencies of the boundary pixels;
  * minimum-area rectangle and Feret diameter: the support function of the
    boundary pixels over a fixed grid of 90 angles in [0, pi/2);
  * ellipse axes and eccentricity: second central moments, with the 1/12
    term of a pixel's own extent;
  * contrast d10/d50/d90: a masked 256-bin histogram's CDF, interpolated.

Every function takes one [H,W] bool mask over the whole image, as the JAX
functions do. The ``*_batch`` forms take [N,h,w] crops placed at
``origin`` [N,2] (x, y) in an image of ``image_hw``: coordinates are the
absolute pixel coordinates, and a neighbour beyond the image counts as
inside the mask for the boundary (the JAX package's ``SAME`` padding), so a
crop that holds all of a mask with one false pixel around it (where it does
not meet the image edge) gives the whole image's counts, extents and
histogram exactly; only the moment sums are taken in another order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# angle resolution of the support-function scan (1 degree)
DEFAULT_NUM_ANGLES = 90
_SQRT2 = np.float32(np.sqrt(np.float32(2.0)))


# XLA's float32 sine, which the JAX package's scan uses, lands one unit in
# the last place above the correctly rounded value at these of the 90 angles
_SIN_ULP_UP_90 = (13, 19, 22)


def scan_directions(num_angles: int = DEFAULT_NUM_ANGLES) -> Tuple[np.ndarray, np.ndarray]:
    """cos and sin [K] float32 of the scan angles k·pi/(2K), the values the
    JAX package's float32 ``cos`` / ``sin`` give (torch's float32
    trigonometry differs in the last bit at some angles, which moves an
    extent by one unit in the last place)."""
    theta = np.arange(num_angles, dtype=np.float32) * np.float32(np.pi / 2 / num_angles)
    c = np.cos(theta.astype(np.float64)).astype(np.float32)
    s = np.sin(theta.astype(np.float64)).astype(np.float32)
    if num_angles == 90:
        s.view(np.uint32)[list(_SIN_ULP_UP_90)] += 1
    return c, s


def _directions(num_angles: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    c, s = scan_directions(num_angles)
    return torch.from_numpy(c).to(device), torch.from_numpy(s).to(device)


def _full(mask: torch.Tensor):
    """One [H,W] mask as a batch of one crop at the origin of an image of
    its own size."""
    return mask[None], torch.zeros((1, 2), dtype=torch.long, device=mask.device), tuple(mask.shape)


def _shift(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the last two axes of a bool map by (dy, dx), zero-filling."""
    h, w = m.shape[-2:]
    out = torch.zeros_like(m)
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else (slice(-dx, w), slice(0, w + dx))
    out[..., yd, xd] = m[..., ys, xs]
    return out


def inside_image(shape, origin: torch.Tensor, image_hw, pad: int = 0) -> torch.Tensor:
    """[N,h+2p,w+2p] bool: the crop's pixels (and a border of ``pad``) that
    lie inside the image."""
    n, h, w = shape
    dev = origin.device
    ys = origin[:, 1, None] + torch.arange(-pad, h + pad, device=dev)[None]
    xs = origin[:, 0, None] + torch.arange(-pad, w + pad, device=dev)[None]
    iy = (ys >= 0) & (ys < image_hw[0])
    ix = (xs >= 0) & (xs < image_hw[1])
    return iy[:, :, None] & ix[:, None, :]


def boundary_4_batch(mask: torch.Tensor, origin: torch.Tensor, image_hw) -> torch.Tensor:
    """Pixels of ``mask`` [N,h,w] with a 4-neighbour outside it; a
    neighbour beyond the image counts as inside."""
    n, h, w = mask.shape
    nb = torch.zeros((n, h + 2, w + 2), dtype=torch.bool, device=mask.device)
    nb[:, 1:-1, 1:-1] = mask
    nb |= ~inside_image(mask.shape, origin, image_hw, pad=1)
    eroded = mask & nb[:, :-2, 1:-1] & nb[:, 2:, 1:-1] & nb[:, 1:-1, :-2] & nb[:, 1:-1, 2:]
    return mask & ~eroded


def _boundary_4(mask: torch.Tensor) -> torch.Tensor:
    """[H,W]: pixels of ``mask`` with a 4-neighbour outside it (the pixels
    a border-following contour passes through)."""
    return boundary_4_batch(*_full(mask))[0]


def _perimeter_from_boundary(b: torch.Tensor) -> torch.Tensor:
    """[N,h,w] boundary -> [N] digital 8-contour length: one step per
    boundary pixel, each sqrt(2) long in the share of adjacencies that are
    diagonal."""
    dims = (-2, -1)
    ax = ((b & _shift(b, 0, 1)).sum(dims) + (b & _shift(b, 1, 0)).sum(dims)).float()
    di = ((b & _shift(b, 1, 1)).sum(dims) + (b & _shift(b, 1, -1)).sum(dims)).float()
    n_b = b.sum(dims).float()
    total = ax + di
    frac = torch.where(total > 0, di / torch.where(total > 0, total, torch.ones_like(total)), torch.zeros_like(total))
    # (1 - f) + f·sqrt(2) with one rounding, as XLA fuses it into a
    # multiply-add in the JAX package's jitted measurement (the float64
    # product of two float32 values is exact)
    step = (frac.double() * float(_SQRT2) + (1.0 - frac).double()).float()
    return n_b * step


def digital_perimeter(mask: torch.Tensor) -> torch.Tensor:
    """Length of the digital 8-contour of one [H,W] mask."""
    return _perimeter_from_boundary(_boundary_4(mask)[None])[0]


def extents_batch(b: torch.Tensor, origin: torch.Tensor, num_angles: int = DEFAULT_NUM_ANGLES):
    """Boundary support-function extents of every crop of ``b`` [N,h,w]
    over ``num_angles`` directions in [0, pi/2) -> (extent_u, extent_v)
    [N,K], v perpendicular to u; 0 for a crop without boundary pixels.
    Only the boundary pixels are projected (memory O(pixels · K))."""
    n = b.shape[0]
    c, s = _directions(num_angles, b.device)
    idx = b.nonzero()
    inst = idx[:, 0]
    x = (idx[:, 2] + origin[inst, 0]).float()[:, None]
    y = (idx[:, 1] + origin[inst, 1]).float()[:, None]
    index = inst[:, None].expand(-1, num_angles)

    def extent(dirx, diry):
        proj = x * dirx[None] + y * diry[None]
        pmax = torch.full((n, num_angles), -torch.inf, device=b.device).scatter_reduce(0, index, proj, "amax")
        pmin = torch.full((n, num_angles), torch.inf, device=b.device).scatter_reduce(0, index, proj, "amin")
        return torch.where(torch.isfinite(pmax), pmax - pmin, torch.zeros_like(pmax))

    return extent(c, s), extent(-s, c)


def support_extents(mask: torch.Tensor, num_angles: int = DEFAULT_NUM_ANGLES):
    """(extent_u [K], extent_v [K]): the width and height of the bounding
    rectangle of one [H,W] mask's boundary at each of ``num_angles``
    rotations in [0, pi/2)."""
    m, origin, hw = _full(mask)
    eu, ev = extents_batch(boundary_4_batch(m, origin, hw), origin, num_angles)
    return eu[0], ev[0]


def _rect_from_extents(eu: torch.Tensor, ev: torch.Tensor):
    """[N,K] extents -> (rect_w, rect_h) [N] at the angle of least positive
    area (the first such angle; angle 0 when no area is positive)."""
    areas = eu * ev
    k = torch.argmin(torch.where(areas > 0, areas, torch.full_like(areas, torch.inf)), dim=-1, keepdim=True)
    return eu.gather(-1, k)[..., 0], ev.gather(-1, k)[..., 0]


def min_area_rect_dims(mask: torch.Tensor, num_angles: int = DEFAULT_NUM_ANGLES):
    """(rect_w, rect_h): the sides of the minimum-area enclosing rectangle
    over the angle scan."""
    eu, ev = support_extents(mask, num_angles)
    w, h = _rect_from_extents(eu[None], ev[None])
    return w[0], h[0]


def feret_diameter(mask: torch.Tensor, num_angles: int = DEFAULT_NUM_ANGLES):
    """The largest caliper diameter over the angle scan."""
    eu, ev = support_extents(mask, num_angles)
    return torch.maximum(eu.max(), ev.max())


def moments_batch(mask: torch.Tensor, origin: torch.Tensor):
    """(major, minor, eccentricity, cx, cy) [N] float32 of the
    moments-equivalent ellipse of each crop, in absolute coordinates. The
    sums and the eigenvalues are taken in float64: the minor axis of an
    elongated blob loses float32 digits to cancellation."""
    n, h, w = mask.shape
    m = mask.double()
    ys = (origin[:, 1, None] + torch.arange(h, device=mask.device)[None]).double()[:, :, None]
    xs = (origin[:, 0, None] + torch.arange(w, device=mask.device)[None]).double()[:, None, :]
    dims = (-2, -1)
    m00 = m.sum(dims)
    safe = torch.clamp(m00, min=1.0)
    cx = (m * xs).sum(dims) / safe
    cy = (m * ys).sum(dims) / safe
    dx, dy = xs - cx[:, None, None], ys - cy[:, None, None]
    mu20 = (m * dx**2).sum(dims) / safe + 1.0 / 12.0
    mu02 = (m * dy**2).sum(dims) / safe + 1.0 / 12.0
    mu11 = (m * dx * dy).sum(dims) / safe
    common = torch.sqrt(torch.clamp((mu20 - mu02) ** 2 + 4 * mu11**2, min=0.0))
    lam1 = (mu20 + mu02 + common) / 2.0
    lam2 = (mu20 + mu02 - common) / 2.0
    major = 4.0 * torch.sqrt(torch.clamp(lam1, min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(lam2, min=0.0))
    ratio = minor / torch.clamp(major, min=1e-6)
    ecc = torch.where(major > 0, torch.sqrt(torch.clamp(1.0 - ratio**2, 0.0, 1.0)), torch.zeros_like(major))
    return tuple(v.float() for v in (major, minor, ecc, cx, cy))


def moments_ellipse(mask: torch.Tensor):
    """(major, minor, eccentricity, cx, cy) of one [H,W] mask's
    moments-equivalent ellipse (the same second moments as the blob)."""
    m, origin, _ = _full(mask)
    return tuple(v[0] for v in moments_batch(m, origin))


def _interp(q: float, cdf: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(q, cdf, edges)`` for each row of ``cdf`` [N,256]
    (constant extrapolation), in its float32 arithmetic."""
    n, size = cdf.shape
    x = torch.full((n, 1), float(np.float32(q)), dtype=torch.float32, device=cdf.device)
    i = torch.searchsorted(cdf.contiguous(), x, right=True).clamp(1, size - 1)
    xp0, xp1 = cdf.gather(1, i - 1), cdf.gather(1, i)
    fp0, fp1 = edges[i - 1], edges[i]
    dx = xp1 - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp0, fp0 + ((x - xp0) / torch.where(dx0, torch.ones_like(dx), dx)) * (fp1 - fp0))
    f = torch.where(x < cdf[:, :1], edges[0].expand_as(f), f)
    f = torch.where(x > cdf[:, -1:], edges[-1].expand_as(f), f)
    return f[:, 0]


def contrast_batch(mask: torch.Tensor, gray: torch.Tensor):
    """(d10, d50, d90) [N] of the gray values [N,h,w] under each crop's
    mask: a 256-bin histogram's CDF, interpolated at 0.1, 0.5, 0.9."""
    n = mask.shape[0]
    bins = torch.floor(torch.clamp(gray, 0.0, 255.0)).long().reshape(n, -1)
    bins = bins + 256 * torch.arange(n, device=mask.device)[:, None]
    hist = torch.zeros(n * 256, dtype=torch.float32, device=mask.device)
    hist.scatter_add_(0, bins.reshape(-1), mask.reshape(-1).float())
    hist = hist.reshape(n, 256)
    total = torch.clamp(hist.sum(1, keepdim=True), min=1e-6)
    cdf = torch.cumsum(hist, dim=1) / total
    edges = torch.arange(256, dtype=torch.float32, device=mask.device)
    return tuple(_interp(q, cdf, edges) for q in (0.10, 0.50, 0.90))


def contrast_percentiles(mask: torch.Tensor, gray: torch.Tensor):
    """(d10, d50, d90) of the intensities under one [H,W] mask."""
    return tuple(v[0] for v in contrast_batch(mask[None], gray[None]))


def measure_batch(
    mask: torch.Tensor,
    origin: torch.Tensor,
    image_hw,
    gray: Optional[torch.Tensor] = None,
    num_angles: int = DEFAULT_NUM_ANGLES,
) -> Dict[str, torch.Tensor]:
    """Every measurement of each crop of ``mask`` [N,h,w] (placed at
    ``origin`` in an image of ``image_hw``; ``gray`` [N,h,w] the crops'
    intensities) -> {name: [N]}, the keys of :func:`measure_mask`."""
    dims = (-2, -1)
    pixel_count = mask.sum(dims).float()
    b = boundary_4_batch(mask, origin, image_hw)
    n_b = b.sum(dims).float()
    eu, ev = extents_batch(b, origin, num_angles)
    rect_w, rect_h = _rect_from_extents(eu, ev)
    major, minor, ecc, cx, cy = moments_batch(mask, origin)
    if gray is not None:
        d10, d50, d90 = contrast_batch(mask, gray)
    else:
        d10 = d50 = d90 = torch.zeros_like(pixel_count)
    return {
        "area": torch.clamp(pixel_count - n_b / 2.0 - 1.0, min=0.0),
        "pixel_count": pixel_count,
        "perimeter": _perimeter_from_boundary(b),
        "rect_w": rect_w,
        "rect_h": rect_h,
        "major_axis": major,
        "minor_axis": minor,
        "eccentricity": ecc,
        "centroid_x": cx,
        "centroid_y": cy,
        "contrast_d10": d10,
        "contrast_d50": d50,
        "contrast_d90": d90,
        "valid": pixel_count > 0,
    }


def measure_mask(
    mask: torch.Tensor,
    gray: Optional[torch.Tensor] = None,
    num_angles: int = DEFAULT_NUM_ANGLES,
) -> Dict[str, torch.Tensor]:
    """Every measurement of one [H,W] bool mask -> a dict of scalars (raw
    pixel units)."""
    m, origin, hw = _full(mask)
    res = measure_batch(m, origin, hw, None if gray is None else gray[None], num_angles)
    return {k: v[0] for k, v in res.items()}
