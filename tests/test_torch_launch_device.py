"""The kernel wrappers launch under their operands' device: a thread may
hold another GPU current (a tile shard's, an ensemble member's), so each
wrapper makes the tensor's device current around its C call, and the C
sources keep what belongs to one GPU (the SM count, the kernels' function
attributes) per device, safely across threads. On the CPU: the RoIAlign
wrappers through a stub library and a recording ``torch.cuda.device``,
every wrapper's C call found inside such a block in its source, the C
sources' per-device state, and the launch counters across threads."""

import ast
import threading
from pathlib import Path

import pytest
import torch

from deepemia_tpu_torch.kernels import int8_conv, int8_quant, roi_align as kra, window_sum
from test_torch_roi_align import _StubKernel, _wrapper_args
from test_torch_roi_align_grad import _bwd_args

CSRC = Path(kra.__file__).parent / "csrc"


class _Current:
    """Stands in for ``torch.cuda.device``: records the device entered and
    whether a launch runs inside the block."""

    inside = None
    entered = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Current.entered.append(self.device)
        _Current.inside = self.device

    def __exit__(self, *exc):
        _Current.inside = None


@pytest.fixture()
def recorded(monkeypatch):
    _Current.entered, _Current.inside = [], None
    stub = _StubKernel()
    launches = []

    def launch(*args):
        launches.append(_Current.inside)
        return stub(*args)

    monkeypatch.setattr(kra, "_require_cuda", lambda tensors: None)
    monkeypatch.setattr(kra, "_library", lambda: launch)
    monkeypatch.setattr(kra, "_bwd_library", lambda: launch)
    monkeypatch.setattr(kra.torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(kra.torch.cuda, "device", _Current)
    return launches


def test_roi_align_forward_launches_under_the_tensors_device(recorded):
    feats, boxes, lv, bi = _wrapper_args()
    kra.roi_align_cuda(feats, boxes, lv, bi, None)
    assert recorded == [boxes.get_device()] and _Current.entered == [boxes.get_device()]


def test_roi_align_backward_launches_under_the_tensors_device(recorded):
    args = _bwd_args()
    kra.roi_align_backward_cuda(*args)
    assert recorded == [args[0].get_device()] and _Current.entered == [args[0].get_device()]


def _c_calls_outside_device_blocks(module, entry_calls):
    """The calls of ``entry_calls`` (source text of the callee) in the
    module that no ``with torch.cuda.device(...)`` block encloses, and how
    many there are in all."""
    tree = ast.parse(Path(module.__file__).read_text())
    outside, total = [], 0

    def visit(node, guarded):
        nonlocal total
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr.func) == "torch.cuda.device" for item in node.items
                if isinstance(item.context_expr, ast.Call)):
            guarded = True
        if isinstance(node, ast.Call) and ast.unparse(node.func) in entry_calls:
            total += 1
            if not guarded:
                outside.append(ast.unparse(node)[:80])
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)
    return outside, total


@pytest.mark.parametrize("module, calls, count", [
    (kra, {"fn", "lib"}, 2),
    (int8_conv, {"_library().int8_conv"}, 1),
    (int8_quant, {"_library().int8_quant"}, 1),
    (window_sum, {"getattr(_library(), entry)"}, 1),
])
def test_every_c_call_runs_under_a_device_block(module, calls, count):
    outside, total = _c_calls_outside_device_blocks(module, calls)
    assert total == count and not outside, outside


@pytest.mark.parametrize("source", ["int8_conv.cu", "int8_quant.cu"])
def test_device_state_is_kept_per_device(source):
    """No SM count or launch setup held once a process: the entry finds the
    operand's device (refusing one that is not current) and reads the SM
    count and runs the setup for that device."""
    text = (CSRC / source).read_text()
    assert '#include "device_state.cuh"' in text
    assert "int num_sms()" not in text and "static bool ready" not in text
    assert "device_state::launch_device(x)" in text and "device_state::num_sms(dev)" in text
    if source == "int8_conv.cu":
        assert "device_state::once_per_device(setup, dev" in text
    state = (CSRC / "device_state.cuh").read_text()
    assert "std::atomic<int> sms[kMaxDevices]" in state and "std::lock_guard<std::mutex>" in state


def test_launch_counters_count_every_thread():
    counter = kra.LaunchCounter()

    def work():
        for _ in range(20000):
            counter.add()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.launches == 80000
    counter.add(2)
    assert counter.launches == 80002
    assert all(isinstance(m.counter, kra.LaunchCounter) for m in (int8_conv, int8_quant, window_sum))
