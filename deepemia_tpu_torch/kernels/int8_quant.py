"""Wrapper of the activation quantizer (``csrc/int8_quant.cu``, K5).

K5 quantizes a conv input for K4 as the JAX package's
``quantize_activation`` does (``deepemia_tpu/models/quant.py:53-64``, which
XLA fuses): per image, ``s = max(max |x|, 1e-12) * float32(1/127)`` and
``clamp(round(x / s), -127, 127)`` in int8 (round half to even), NHWC, in
x's own layout (the kernel takes C a multiple of 16, the channels K4 loads
with 16-byte copies: every conv input of R50/R101 + FPN but the image) or,
for the stem, as ``space_to_depth``: each 2x2 block of pixels one pixel of
16 channels (its 4 x 3 values and 4 zeros), which K4 reads as a 4x4
stride-1 conv (``models/quant.py:space_to_depth_weights``). It returns
``(x_q, amax)``, the floored max, as its plain version
``models/quant.py:_quantize_activation`` does; the module hands ``amax``
on to K4, whose epilogue makes the dequantization scale of it.

Where x's producer took its floored max (K4's epilogue, ``amax``), one
kernel launches: the quantize pass, which reads x once. Otherwise two: the
max pass and the quantize pass. The plain version takes the max from x
in either case, so that holding the kernel to it also holds the
producer's max to x's own.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(counted as one launch a kernel: one with ``amax``, two without) or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.roi_align import LaunchCounter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SLICES = 1024  # csrc/int8_quant.cu:kMaxSlices, the per-image partials of the max pass

counter = LaunchCounter()  # K5's kernels, launched by int8_quantize on CUDA tensors


def space_to_depth(x_q: torch.Tensor) -> torch.Tensor:
    """[N,C,H,W] (C <= 4) -> [N,16,ceil(H/2),ceil(W/2)] ``channels_last``:
    output pixel (y, x) holds input pixels (2y + dy, 2x + dx) at channels
    (2 dy + dx) C + c (zeros past the input's edge), then zero channels."""
    n, c, h, w = x_q.shape
    t = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, 0, w % 2, 0, h % 2))
    t = t.reshape(n, (h + 1) // 2, 2, (w + 1) // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    t = F.pad(t.reshape(n, (h + 1) // 2, (w + 1) // 2, 4 * c), (0, 16 - 4 * c))
    return t.permute(0, 3, 1, 2)


def image_amax(x: torch.Tensor) -> torch.Tensor:
    """[N,...] float -> float32 [N]: the per-image max |x| floored at
    1e-12, the quantizer's max (``models/quant.py:_floor``). The max and
    the min are taken in x's dtype, in one pass (both are exact, and max
    |x| = max(max, -min)), over x's memory order."""
    flat = x.permute(0, *range(2, x.ndim), 1) if x.is_contiguous(memory_format=torch.channels_last) else x
    lo, hi = torch.aminmax(flat.reshape(x.shape[0], -1), dim=1)
    return torch.maximum(hi, -lo).float().clamp_min(1e-12)


def int8_quantize_plain(x: torch.Tensor, space_to_depth_blocks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`int8_quantize`, on any device: the
    module's torch-op quantizer (its max taken from x, whatever the
    producer's), then the space-to-depth layout where asked."""
    from deepemia_tpu_torch.models.quant import _quantize_activation  # the models import this module

    x_q, amax = _quantize_activation(x)
    return (space_to_depth(x_q) if space_to_depth_blocks else x_q), amax


def _check(x: torch.Tensor, space_to_depth_blocks: bool = False, amax: Optional[torch.Tensor] = None) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"int8_quantize takes float32 or bfloat16 activations, not {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"int8_quantize takes [N,C,H,W] activations, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_quantize: activations must be channels_last (NHWC in memory)")
    if space_to_depth_blocks and 4 * x.shape[1] > 16:
        raise ValueError(f"int8_quantize: space-to-depth takes at most 4 channels, got {x.shape[1]}")
    if amax is not None and (amax.dtype != torch.float32 or tuple(amax.shape) != (x.shape[0],)
                             or amax.device != x.device or not amax.is_contiguous()):
        raise ValueError(f"int8_quantize: the producer's max must be float32 [{x.shape[0]}] on {x.device}, got "
                         f"{amax.dtype} {tuple(amax.shape)} on {amax.device}")


def int8_quantize(x: torch.Tensor, space_to_depth_blocks: bool = False,
                  amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,C,H,W] float32 or bfloat16 ``x`` (``channels_last``, NHWC in
    memory) -> (int8 [N,C,H,W] ``channels_last``, float32 per-image max
    |x| floored at 1e-12 [N]). With ``space_to_depth_blocks`` (C <= 4) the
    int8 output is :func:`space_to_depth`'s layout,
    [N,16,ceil(H/2),ceil(W/2)]. The kernel takes C a multiple of 16 in
    x's own layout. ``amax``: x's floored per-image max as its producer
    took it (``int8_conv2d(..., with_max=True)``); the kernel then quantizes
    in one pass and returns it."""
    _check(x, space_to_depth_blocks, amax)
    if x.is_cpu:
        return int8_quantize_plain(x, space_to_depth_blocks)
    out = launch(x, space_to_depth_blocks, amax)
    counter.add(1 if amax is not None else 2)  # the quantize pass, after the max pass where it runs
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("int8_quant")
    fn = lib.int8_quant
    fn.restype = ctypes.c_int
    # x, q, amax_in, partial, amax; n, h, w, c, space_to_depth, dtype_code; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def launch(x: torch.Tensor, space_to_depth_blocks: bool = False,
           amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks the layout and launches K5 into new outputs: the quantize
    pass with the producer's ``amax`` (returned as it is), or the max pass
    and the quantize pass. Counts nothing."""
    if not x.is_cuda:
        raise ValueError(f"int8_quantize: no kernel for device {x.device}")
    _check(x, space_to_depth_blocks, amax)
    n, c, h, w = x.shape
    if not space_to_depth_blocks and c % 16:
        raise ValueError(f"int8_quantize: the kernel takes C a multiple of 16 (or space-to-depth), got {c}")
    if x.data_ptr() % 16:
        raise ValueError("int8_quantize: activations must be 16-byte aligned")
    if n > 65535:
        raise ValueError(f"int8_quantize takes at most 65535 images, got {n}")
    if h * w >= 2**31:
        raise ValueError(f"int8_quantize takes images below 2^31 pixels, got {h}x{w}")
    shape = (n, 16, (h + 1) // 2, (w + 1) // 2) if space_to_depth_blocks else (n, c, h, w)
    q = torch.empty(shape, dtype=torch.int8, device=x.device, memory_format=torch.channels_last)
    if amax is None:
        out_amax = torch.empty((n,), dtype=torch.float32, device=x.device)
        partial = torch.empty((n * MAX_SLICES,), dtype=torch.int32, device=x.device)
        ptrs = (None, partial.data_ptr(), out_amax.data_ptr())
    else:
        out_amax, ptrs = amax, (amax.data_ptr(), None, None)
    device = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    with torch.cuda.device(device):  # the launch, and the SM count it sizes the grid by, are x's GPU's
        status = _library().int8_quant(x.data_ptr(), q.data_ptr(), *ptrs, n, h, w, c, int(space_to_depth_blocks),
                                       _DTYPE_CODE[x.dtype], stream)
    if status != 0:
        raise RuntimeError(f"int8_quant launch failed: CUDA error {status} (x {tuple(x.shape)} {x.dtype}, "
                           f"space-to-depth {space_to_depth_blocks}, producer's max {amax is not None})")
    return q, out_amax
