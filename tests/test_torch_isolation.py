"""The port stands alone: no JAX, Flax, Optax, Orbax, ``deepemia_tpu``,
OpenCV, PIL or scikit-learn imports, and its entry points run on CUDA
unless told otherwise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepemia_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deepemia_tpu", "cv2", "PIL", "sklearn")


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
        ("cv2", True),
        ("PIL.Image", True),
        ("sklearn.model_selection", True),
        ("orbax.checkpoint", True),
        ("optax", True),
        ("deepemia_tpu_torch.ops.boxes", False),
        ("torch.nn", False),
    ],
)
def test_forbidden_rule(module, bad):
    assert _forbidden(module) is bad


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    walked = {f.relative_to(PORT).as_posix() for f in files}
    assert {"train/targets.py", "train/losses.py", "train/trainer.py"} <= walked
    assert {
        "inference/pipeline.py", "inference/multiscale.py", "inference/postprocess.py",
        "inference/constraints.py", "inference/measure_host.py", "ops/rle.py", "data/models.py",
        "native/__init__.py", "kernels/window_sum.py", "tools/bench_decouple.py",
        "config/config.py", "config/schema.py", "utils/exceptions.py", "ops/cv.py",
        "inference/scalebar.py", "inference/ensemble.py", "inference/viz.py", "inference/measure.py",
        "ops/morphometrics.py", "ops/image.py", "cli/main.py", "utils/eta.py", "utils/logging_utils.py",
        "utils/device.py", "utils/safe_ops.py", "utils/storage.py", "utils/profiling.py",
        "data/datasets.py", "data/loader.py", "train/augment.py", "train/evaluator.py", "train/workflow.py",
        "models/weights.py", "models/quant.py", "kernels/int8_conv.py", "kernels/int8_quant.py",
        "cli/__init__.py", "cli/wizard.py", "gui/server.py", "utils/color.py", "version.py",
    } <= walked
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
        "deepemia_tpu_torch.kernels.roi_align, deepemia_tpu_torch.train.trainer, "
        "deepemia_tpu_torch.inference.pipeline, deepemia_tpu_torch.inference.multiscale, "
        "deepemia_tpu_torch.kernels.window_sum, deepemia_tpu_torch.tools.bench_decouple, "
        "deepemia_tpu_torch.native, deepemia_tpu_torch.data.models, deepemia_tpu_torch.config.config, "
        "deepemia_tpu_torch.inference.scalebar, deepemia_tpu_torch.inference.ensemble, deepemia_tpu_torch.ops.cv, "
        "deepemia_tpu_torch.cli.main, deepemia_tpu_torch.inference.viz, deepemia_tpu_torch.ops.morphometrics, "
        "deepemia_tpu_torch.utils.storage, deepemia_tpu_torch.utils.device, deepemia_tpu_torch.utils.logging_utils, "
        "deepemia_tpu_torch.data.datasets, deepemia_tpu_torch.data.loader, deepemia_tpu_torch.train.augment, "
        "deepemia_tpu_torch.train.evaluator, deepemia_tpu_torch.train.workflow, deepemia_tpu_torch.models.weights, "
        "deepemia_tpu_torch.models.quant, deepemia_tpu_torch.kernels.int8_conv, deepemia_tpu_torch.kernels.int8_quant, "
        "deepemia_tpu_torch.cli.wizard, deepemia_tpu_torch.gui.server, deepemia_tpu_torch.utils.color, "
        "deepemia_tpu_torch.version; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'deepemia_tpu', 'cv2', 'PIL', 'sklearn', 'psutil') "
        "or m.startswith('google.cloud.storage')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_yaml_is_imported_only_inside_functions():
    """PyYAML may be absent where the port runs: no module imports it at
    load time (tests/test_torch_config.py imports the package without it)."""
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] == "yaml"], f


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    from deepemia_tpu_torch.inference.engine import TileEngine
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline
    from deepemia_tpu_torch.tools import bench_decouple
    from deepemia_tpu_torch.models.mask_rcnn import build_model, build_train_model
    from deepemia_tpu_torch.train.trainer import train
    from deepemia_tpu_torch.train.workflow import evaluate_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("R50", num_classes=2)
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TileEngine(model)
    assert TileEngine(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_model("R50", num_classes=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train([], 2, str(tmp_path), max_steps_override=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_model("ds", str(tmp_path), config={"paths": {}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferencePipeline("ds", str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_decouple.main()
    res = bench_decouple.main(device="cpu", size=16, channels=8, dtype=torch.float32, warmup=0, reps=1, steps=1)
    assert set(res) == {"no_consumer", "direct", "f32_convert", "identity_dot", "flip", "transpose"}
