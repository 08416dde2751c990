"""Port parity of the CLI's utilities: the ETA store, the path-guarded
removal, ``LocalStorage`` and ``GsutilStorage`` (against a ``gsutil`` stub
on PATH that fails a set number of times, so the retry runs) against the
JAX package's copies; the port's logging setup, memory telemetry, CUDA
preflight and ``torch.profiler`` trace. No test touches the network."""

import json
import logging
import os
import stat
import sys
from pathlib import Path

import pytest
import torch

import deepemia_tpu.utils.storage as jax_storage
import deepemia_tpu_torch.config.config as port_cfg
import deepemia_tpu_torch.utils.storage as pt_storage
from deepemia_tpu.utils import eta as jax_eta
from deepemia_tpu.utils import safe_ops as jax_safe
from deepemia_tpu_torch.utils import device as pt_device
from deepemia_tpu_torch.utils import eta as pt_eta
from deepemia_tpu_torch.utils import logging_utils as pt_logging
from deepemia_tpu_torch.utils import profiling as pt_profiling
from deepemia_tpu_torch.utils import safe_ops as pt_safe
from deepemia_tpu_torch.utils.exceptions import PipelineError, StorageError

torch.set_num_threads(2)


def test_eta_matches_jax(tmp_path):
    files = {m: str(tmp_path / m / "eta.json") for m in ("jax", "port")}
    for mod, key in ((jax_eta, "jax"), (pt_eta, "port")):
        assert mod.read_eta_data(files[key]) == jax_eta.DEFAULT_ETA
        mod.update_eta_data(files[key], "inference", 12.0, num_images=3)
        mod.update_eta_data(files[key], "inference", 30.0, num_images=5)
        mod.update_eta_data(files[key], "train", 100.0)
    assert json.loads(Path(files["port"]).read_text()) == json.loads(Path(files["jax"]).read_text())
    for task, n in (("inference", 7), ("train", None), ("upload", None), ("unknown", None)):
        assert pt_eta.estimate_eta(files["port"], task, n) == jax_eta.estimate_eta(files["jax"], task, n)
    Path(files["port"]).write_text("{corrupt")
    assert pt_eta.read_eta_data(files["port"]) == jax_eta.DEFAULT_ETA


def _tree(root: Path):
    return sorted((str(p.relative_to(root)), p.read_bytes() if p.is_file() else None) for p in root.rglob("*"))


def _mktree(root: Path):
    (root / "base" / "a" / "b").mkdir(parents=True)
    (root / "base" / "a" / "b" / "x.txt").write_text("x")
    (root / "base" / "y.txt").write_text("y")
    (root / "outside").mkdir()
    (root / "outside" / "keep.txt").write_text("k")


def test_safe_ops_match_jax(tmp_path):
    for mod in ("jax", "port"):
        _mktree(tmp_path / mod)
    for mod, lib in (("jax", jax_safe), ("port", pt_safe)):
        r = tmp_path / mod
        base = [str(r / "base")]
        with pytest.raises(ValueError, match="outside allowed"):
            lib.validate_path_safety(str(r / "base" / ".." / "outside" / "keep.txt"), base)
        removed = lib.safe_remove_files(
            [str(r / "base" / "a"), str(r / "outside" / "keep.txt"), str(r / "base" / ".." / "outside"),
             str(r / "base" / "missing")], base,
        )
        assert [p.relative_to(r) for p in removed] == [Path("base/a")]
        lib.safe_copy(str(r / "base" / "y.txt"), str(r / "base" / "c" / "y2.txt"), base)
        lib.safe_move(str(r / "base" / "c" / "y2.txt"), str(r / "base" / "d" / "y3.txt"), base)
        with pytest.raises(ValueError):
            lib.safe_copy(str(r / "base" / "y.txt"), str(r / "outside" / "z.txt"), base)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    stale = tmp_path / "tmp" / "deepemia_old"
    stale.mkdir(parents=True)
    os.utime(stale, (0, 0))
    assert pt_safe.cleanup_old_temp_dirs(root=str(tmp_path / "tmp")) == 1 and not stale.exists()


def _storage_ops(lib, root: Path):
    """The same operations on a LocalStorage of ``lib``; -> what they return."""
    store = lib.LocalStorage(root / "bucket")
    src = root / "bucket" / "DATASET" / "ds"
    src.mkdir(parents=True)
    (src / "img.tif").write_bytes(b"tif")
    (root / "bucket" / "dataset_info.json").write_text("{}")
    store.download_dataset("ds", root / "local" / "ds")
    store.download_file("dataset_info.json", root / "local" / "info.json")
    results = root / "results"
    (results / "sub").mkdir(parents=True)
    for name in ("measurements_results.csv", "R50_flip_results.csv", "a.tif_predictions.png", "notes.bin",
                 "sub/class_legend.png", "run.log"):
        (results / name).write_text(name)
    uploaded = store.upload_inference_results(results, timestamp="T0")
    store.upload_tree(results / "sub", "trees/sub")
    archive = store.archive_results([results / "notes.bin", results / "sub", root / "missing"], timestamp="T1")
    listed = store.list_prefix("Archive")
    deleted = store.delete_prefix("trees")
    with pytest.raises(lib.StorageError):
        store.download_dataset("absent", root / "local" / "absent")
    return [str(p.relative_to(results)) for p in uploaded], archive, listed, deleted


def test_local_storage_matches_jax(tmp_path):
    ref = _storage_ops(jax_storage, tmp_path / "jax")
    got = _storage_ops(pt_storage, tmp_path / "port")
    assert got == ref
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.fixture()
def gsutil_stub(tmp_path, monkeypatch):
    """A ``gsutil`` on PATH that appends its arguments to a log and fails
    while a countdown file holds a positive number."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "gsutil.log"
    fails = tmp_path / "fails"
    fails.write_text("0")
    script = bindir / "gsutil"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"log, fails = {str(log)!r}, {str(fails)!r}\n"
        "open(log, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "n = int(open(fails).read())\n"
        "if n > 0:\n"
        "    open(fails, 'w').write(str(n - 1))\n"
        "    sys.stderr.write('transient failure')\n"
        "    sys.exit(1)\n"
        "if sys.argv[1:3] == ['ls', '-r']:\n"
        "    print(sys.argv[3].rstrip('/') + '/f1.csv')\n"
        "    print(sys.argv[3].rstrip('/') + '/dir/')\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    sleeps = []
    for lib in (jax_storage, pt_storage):
        monkeypatch.setattr(lib.time, "sleep", sleeps.append)
    return {"log": log, "fails": fails, "sleeps": sleeps}


def _gsutil_ops(lib, stub, root: Path):
    store = lib.GsutilStorage("bkt/")
    stub["fails"].write_text("2")  # two transient failures, then success
    store.download_file("dataset_info.json", root / "info.json")
    store.download_dataset("ds", root / "ds")
    store.upload_file(root / "x.csv", "Archive/T/x.csv")
    store.upload_tree(root / "res", "Archive/T/res")
    listed = store.list_prefix("Archive")
    n = store.delete_prefix("Archive/T")
    stub["fails"].write_text("5")
    with pytest.raises(lib.StorageError, match="after 3 attempts"):
        store.upload_file(root / "x.csv", "Archive/T/y.csv")
    stub["fails"].write_text("0")
    calls = stub["log"].read_text().replace(str(root), "ROOT")
    stub["log"].write_text("")
    return listed, n, calls


def test_gsutil_storage_matches_jax_with_retries(tmp_path, gsutil_stub):
    ref = _gsutil_ops(jax_storage, gsutil_stub, tmp_path / "jax")
    jax_sleeps = list(gsutil_stub["sleeps"])
    gsutil_stub["sleeps"].clear()
    got = _gsutil_ops(pt_storage, gsutil_stub, tmp_path / "port")
    assert got == ref
    assert got[0] == ["Archive/f1.csv"] and got[1] == 1
    assert gsutil_stub["sleeps"] == jax_sleeps == [2.0, 4.0, 2.0, 4.0]
    assert got[2].count("-m cp ROOT/x.csv gs://bkt/Archive/T/y.csv") == 3
    with pytest.raises(StorageError, match="requires a bucket"):
        pt_storage.GsutilStorage("")


def test_storage_from_config(tmp_path, gsutil_stub, monkeypatch):
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(tmp_path / "home"))
    assert isinstance(pt_storage.storage_from_config({"bucket": "b"}), pt_storage.GsutilStorage)
    local = pt_storage.storage_from_config({"bucket": ""})
    assert isinstance(local, pt_storage.LocalStorage) and local.root == port_cfg.framework_home() / "bucket"


@pytest.fixture()
def fresh_logging(monkeypatch):
    """The package logger as it was before the test."""
    logger = logging.getLogger("deepemia_tpu_torch")
    saved = (list(logger.handlers), logger.level, logger.propagate)
    monkeypatch.setattr(pt_logging, "_configured", False)
    yield
    for h in logger.handlers:
        if h not in saved[0]:
            h.close()
    logger.handlers[:], logger.level, logger.propagate = saved


def test_logging_memory_preflight_and_trace(tmp_path, monkeypatch, fresh_logging):
    logger = pt_logging.setup_logging(str(tmp_path / "logs"), "warning")
    assert logger.name == "deepemia_tpu_torch" and not logger.propagate
    console = [h for h in logger.handlers if getattr(h, "_deepemia_console", False)]
    assert len(console) == 1 and console[0].level == logging.WARNING
    pt_logging.setup_logging(str(tmp_path / "logs"), "debug")
    assert console[0].level == logging.DEBUG and len([h for h in logger.handlers
                                                      if isinstance(h, logging.FileHandler)]) == 1
    pt_logging.system_logger.debug("hello")
    assert any("hello" in p.read_text() for p in (tmp_path / "logs").glob("system_*.log"))
    stats = pt_logging.log_memory_usage("t")
    assert stats["host_rss_mb"] > 1
    monkeypatch.setitem(sys.modules, "psutil", None)  # without psutil: /proc
    assert abs(pt_logging.host_rss_bytes() / 1e6 - stats["host_rss_mb"]) < 0.5 * stats["host_rss_mb"]

    assert pt_device.check_accelerator_availability("cpu")["platform"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PipelineError, match="CUDA is not available"):
        pt_device.check_accelerator_availability("cuda")

    with pt_profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["traceEvents"]
    with pt_profiling.trace(None):
        pass
    with pytest.raises(ZeroDivisionError):
        with pt_profiling.trace(str(tmp_path / "trace2")):
            1 / 0
