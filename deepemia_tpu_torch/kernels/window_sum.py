"""Wrapper of the windowed-sum kernel (``csrc/window_sum.cu``, K3).

K3 replaces the Pallas kernel ``consume`` of the JAX package's
``tools/bench_decouple.py``: the float32 sum of the window
``feat[0:8, 0:16, :]`` of a row-major [H,W,C] feature map, as a [1,1]
float32 tensor. A CPU tensor takes the plain version
(:func:`window_sum_plain`); a CUDA tensor launches the kernel or raises.

The kernel is one thread-block cluster of :data:`CLUSTER` blocks; which
instance runs and which loads each block and thread make is the plan of
:func:`window_sum_plan`, a pure function of the operand's shape, type and
alignment, handed to the kernel as arguments.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.roi_align import LaunchCounter

WINDOW = (8, 16)  # rows, columns
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {0: 4, 1: 2}  # by dtype code
THREADS = 256  # threads per block, as compiled (window_sum.cu: kThreads)
CLUSTER = 8  # blocks in the cluster: block b sums window rows b, b + 8, ...
VECTOR, SCALAR = 0, 1  # kernel instances: 16-byte loads; element loads
INSTANCE_NAMES = {VECTOR: "vector", SCALAR: "scalar"}
# loads a thread issues before its first add, as compiled (kVectorBatch, kScalarBatch)
BATCH = {VECTOR: 4, SCALAR: 16}

counter = LaunchCounter()  # K3, window_sum on CUDA tensors


class WindowSumPlan(NamedTuple):
    """The kernel's arguments after the operand's base, in its order.
    Block ``b`` of ``blocks`` sums window rows ``b, b + blocks, ...``; in
    each row thread ``t`` makes loads ``t, t + THREADS, ...`` of
    :attr:`vec` elements, :attr:`batch` at a time, those below
    ``loads_per_row``; a window row starts ``pitch`` elements after the
    previous one."""

    dtype: int  # 0 float32, 1 bfloat16
    instance: int
    blocks: int
    rows: int
    loads_per_row: int
    pitch: int

    @property
    def vec(self) -> int:
        """Elements per load."""
        return 16 // _ESIZE[self.dtype] if self.instance == VECTOR else 1

    @property
    def batch(self) -> int:
        """Loads a thread issues before its first add."""
        return BATCH[self.instance]


@functools.lru_cache(maxsize=256)
def window_sum_plan(shape, dtype: torch.dtype, byte_offset: int) -> WindowSumPlan:
    """The plan for a row-major [H,W,C] operand of ``dtype`` whose first
    element lies ``byte_offset`` bytes past a 16-byte boundary (only the
    remainder mod 16 matters). The vector instance needs the base and the
    row pitch ``W*C`` 16-byte aligned (a window row of ``16*C`` elements
    always is); otherwise the scalar instance runs."""
    _, w, c = shape
    rows, cols = WINDOW
    code = _DTYPE_CODE[dtype]
    instance = VECTOR if byte_offset % 16 == 0 and (w * c * _ESIZE[code]) % 16 == 0 else SCALAR
    vec = 16 // _ESIZE[code] if instance == VECTOR else 1
    return WindowSumPlan(code, instance, CLUSTER, rows, cols * c // vec, w * c)


def window_sum_plain(feat: torch.Tensor) -> torch.Tensor:
    """[H,W,C] -> [1,1] float32 sum of the [8,16,C] window."""
    rows, cols = WINDOW
    return feat[:rows, :cols].float().sum().reshape(1, 1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library, its two entries' signatures bound once."""
    lib = _build.load("window_sum")
    for fn in (lib.window_sum, lib.window_sum_empty):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    return lib


def plan_of(feat: torch.Tensor) -> WindowSumPlan:
    """The plan :func:`window_sum` launches for a row-major ``feat``."""
    return window_sum_plan(feat.shape, feat.dtype, feat.data_ptr() % 16)


def launch(feat: torch.Tensor, entry: str = "window_sum") -> torch.Tensor:
    """Checks ``feat``, makes it row-major and launches the library's
    ``entry`` (``window_sum``, or ``window_sum_empty``, the same launch of
    a kernel that does nothing) with its plan into a new [1,1] float32
    tensor. Counts nothing."""
    if not feat.is_cuda:
        raise ValueError(f"window_sum: no kernel for device {feat.device}")
    rows, cols = WINDOW
    if feat.ndim != 3 or feat.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_sum takes [H,W,C] float32 or bfloat16, got {tuple(feat.shape)} {feat.dtype}")
    h, w, _ = feat.shape
    if h < rows or w < cols:
        raise ValueError(f"window_sum: feature map {h}x{w} is smaller than the {rows}x{cols} window")
    if not feat.is_contiguous():
        feat = feat.contiguous()
    ptr = feat.data_ptr()
    plan = window_sum_plan(feat.shape, feat.dtype, ptr % 16)
    out = feat.new_empty((1, 1), dtype=torch.float32)
    # the raw handle of the current stream, as torch's own generated
    # kernels take it: torch.cuda.current_stream() builds a Stream object,
    # several microseconds of a call this short
    stream = torch._C._cuda_getCurrentRawStream(feat.get_device())
    status = getattr(_library(), entry)(ptr, *plan, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {status} ({plan})")
    return out


def window_sum(feat: torch.Tensor) -> torch.Tensor:
    """[H,W,C] float32 or bfloat16 -> [1,1] float32 sum of the window
    ``feat[0:8, 0:16, :]``. On the card the kernel reads a row-major
    operand: a view of another layout (a transpose) is copied first."""
    if feat.is_cpu:
        return window_sum_plain(feat)
    out = launch(feat)
    counter.launches += 1
    return out
