"""The port stands alone: no JAX, Flax or ``deepemia_tpu`` imports, and its
entry points run on CUDA unless told otherwise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepemia_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepemia_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize(
    "module, bad",
    [
        ("jax.numpy", True),
        ("flax.linen", True),
        ("deepemia_tpu", True),
        ("deepemia_tpu.ops.boxes", True),
        ("deepemia_tpu_torch.ops.boxes", False),
        ("torch.nn", False),
    ],
)
def test_forbidden_rule(module, bad):
    assert _forbidden(module) is bad


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 16
    offenders = [
        f"{f.relative_to(ROOT)}: {m}"
        for f in files
        for m in _imported_modules(f)
        if _forbidden(m)
    ]
    assert not offenders, offenders
    smoke = ROOT / "chip_smoke.py"
    assert not [m for m in _imported_modules(smoke) if _forbidden(m)]


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, deepemia_tpu_torch, deepemia_tpu_torch.inference.engine, "
        "deepemia_tpu_torch.kernels.roi_align; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'deepemia_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    from deepemia_tpu_torch.inference.engine import TileEngine
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("R50", num_classes=2)
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TileEngine(model)
    assert TileEngine(model, device="cpu").device.type == "cpu"
