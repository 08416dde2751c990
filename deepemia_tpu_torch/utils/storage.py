"""Artefact storage with retry and backoff (a copy of the JAX package's
``utils/storage.py``).

The bucket layout is ``DATASET/<name>/``, ``DATASET/INFERENCE/`` and
``Archive/<timestamp>/``. ``Storage`` holds the shared operations (the
selective upload of inference results with a per-file retry and an upload
summary, the timestamped archive); its backends are ``LocalStorage`` (a
directory, the default and what the tests use), ``GsutilStorage`` (the
``gsutil`` command) and ``GcsClientStorage`` (the ``google-cloud-storage``
client, imported only when it is built).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import time
from fnmatch import fnmatch
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from deepemia_tpu_torch.utils.exceptions import StorageError

log = logging.getLogger("deepemia_tpu_torch.storage")

# the inference results a selective upload sends
ESSENTIAL_RESULT_PATTERNS = (
    "*measurements_results.csv",
    "*_results.csv",
    "*metrics.csv",
    "*.png",
    "*.jpg",
    "*upload_summary.txt",
    "*.log",
)


def with_retry(
    fn: Callable[[], None],
    attempts: int = 3,
    base_delay: float = 2.0,
    what: str = "storage op",
) -> None:
    """Run ``fn`` with exponential backoff: delays 2·2^a seconds."""
    last: Optional[Exception] = None
    for attempt in range(attempts):
        try:
            fn()
            return
        except Exception as e:  # noqa: BLE001 - uniform retry surface
            last = e
            delay = base_delay * (2**attempt)
            log.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.0fs",
                what,
                attempt + 1,
                attempts,
                e,
                delay,
            )
            if attempt < attempts - 1:
                time.sleep(delay)
    raise StorageError(f"{what} failed after {attempts} attempts: {last}")


class Storage:
    """Abstract artifact store with the deepEMIA bucket layout."""

    def download_dataset(self, dataset_name: str, local_dir: Path) -> None:
        raise NotImplementedError

    def download_file(self, remote_rel: str, local_path: Path) -> None:
        raise NotImplementedError

    def upload_tree(self, local_dir: Path, remote_rel: str) -> None:
        raise NotImplementedError

    def upload_file(self, local_path: Path, remote_rel: str) -> None:
        raise NotImplementedError

    # listing and wiping a prefix
    def list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        raise NotImplementedError

    # -- shared high-level operations --------------------------------------

    def upload_tree_wipe(self, local_dir: Path, remote_rel: str) -> None:
        """Upload a directory, first wiping the destination prefix."""
        try:
            self.delete_prefix(remote_rel)
        except NotImplementedError:
            pass
        self.upload_tree(local_dir, remote_rel)

    def archive_results(
        self,
        sources: Sequence[Path],
        timestamp: Optional[str] = None,
    ) -> str:
        """Upload result files/dirs into ``Archive/<timestamp>/``."""
        ts = timestamp or time.strftime("%Y-%m-%d_%H-%M-%S")
        dest = f"Archive/{ts}"
        for src in sources:
            src = Path(src)
            if not src.exists():
                continue
            if src.is_dir():
                self.upload_tree(src, f"{dest}/{src.name}")
            else:
                self.upload_file(src, f"{dest}/{src.name}")
        return dest

    def upload_inference_results(
        self, result_dir: Path, timestamp: Optional[str] = None
    ) -> List[Path]:
        """Selective upload of the essential result files, each with its own
        retry, and a generated upload summary."""
        result_dir = Path(result_dir)
        ts = timestamp or time.strftime("%Y-%m-%d_%H-%M-%S")
        files = [
            p
            for p in sorted(result_dir.rglob("*"))
            if p.is_file()
            and any(fnmatch(p.name, pat) for pat in ESSENTIAL_RESULT_PATTERNS)
        ]
        uploaded: List[Path] = []
        failed: List[Path] = []
        for p in files:
            rel = p.relative_to(result_dir)
            try:
                with_retry(
                    lambda p=p, rel=rel: self.upload_file(
                        p, f"Archive/{ts}/{rel}"
                    ),
                    what=f"upload {rel}",
                )
                uploaded.append(p)
            except StorageError:
                failed.append(p)
        summary = result_dir / "upload_summary.txt"
        with open(summary, "w") as f:
            f.write(f"Upload at {ts}\nUploaded {len(uploaded)} files\n")
            for p in uploaded:
                f.write(f"  OK   {p.relative_to(result_dir)}\n")
            for p in failed:
                f.write(f"  FAIL {p.relative_to(result_dir)}\n")
        try:
            self.upload_file(summary, f"Archive/{ts}/upload_summary.txt")
        except Exception:  # noqa: BLE001
            pass
        return uploaded


class LocalStorage(Storage):
    """Directory-backed store mirroring the GCS bucket layout locally."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def download_dataset(self, dataset_name: str, local_dir: Path) -> None:
        src = self.root / "DATASET" / dataset_name
        if not src.exists():
            raise StorageError(f"Dataset not found in store: {src}")
        local_dir = Path(local_dir)
        if local_dir.exists():
            shutil.rmtree(local_dir)
        shutil.copytree(src, local_dir)

    def download_file(self, remote_rel: str, local_path: Path) -> None:
        src = self.root / remote_rel
        if not src.exists():
            raise StorageError(f"File not found in store: {src}")
        local_path = Path(local_path)
        local_path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, local_path)

    def upload_tree(self, local_dir: Path, remote_rel: str) -> None:
        dst = self.root / remote_rel
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(local_dir, dst)

    def upload_file(self, local_path: Path, remote_rel: str) -> None:
        dst = self.root / remote_rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(local_path, dst)

    def list_prefix(self, prefix: str) -> List[str]:
        base = self.root / prefix
        if not base.exists():
            return []
        return sorted(
            str(p.relative_to(self.root)) for p in base.rglob("*") if p.is_file()
        )

    def delete_prefix(self, prefix: str) -> int:
        base = self.root / prefix
        if not base.exists():
            return 0
        n = sum(1 for p in base.rglob("*") if p.is_file())
        shutil.rmtree(base)
        return n


class GsutilStorage(Storage):
    """gsutil-subprocess backend (used when a bucket is configured and the
    gsutil binary is on PATH)."""

    def __init__(self, bucket: str):
        if not bucket:
            raise StorageError("GsutilStorage requires a bucket name")
        self.bucket = bucket.rstrip("/")

    def _run(self, *args: str) -> None:
        cmd = ["gsutil", "-m", *args]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise StorageError(
                f"gsutil failed ({proc.returncode}): {proc.stderr.strip()[:500]}"
            )

    def download_dataset(self, dataset_name: str, local_dir: Path) -> None:
        local_dir = Path(local_dir)
        if local_dir.exists():
            shutil.rmtree(local_dir)
        local_dir.mkdir(parents=True, exist_ok=True)
        with_retry(
            lambda: self._run(
                "cp", "-r", f"gs://{self.bucket}/DATASET/{dataset_name}/*",
                str(local_dir),
            ),
            what=f"download dataset {dataset_name}",
        )

    def download_file(self, remote_rel: str, local_path: Path) -> None:
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        with_retry(
            lambda: self._run(
                "cp", f"gs://{self.bucket}/{remote_rel}", str(local_path)
            ),
            what=f"download {remote_rel}",
        )

    def upload_tree(self, local_dir: Path, remote_rel: str) -> None:
        with_retry(
            lambda: self._run(
                "cp", "-r", str(local_dir), f"gs://{self.bucket}/{remote_rel}"
            ),
            what=f"upload tree {remote_rel}",
        )

    def upload_file(self, local_path: Path, remote_rel: str) -> None:
        with_retry(
            lambda: self._run(
                "cp", str(local_path), f"gs://{self.bucket}/{remote_rel}"
            ),
            what=f"upload {remote_rel}",
        )

    def list_prefix(self, prefix: str) -> List[str]:
        cmd = ["gsutil", "ls", "-r", f"gs://{self.bucket}/{prefix}"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if "matched no objects" in proc.stderr:
                return []
            raise StorageError(f"gsutil ls failed: {proc.stderr.strip()[:500]}")
        head = f"gs://{self.bucket}/"
        return sorted(
            line[len(head):]
            for line in proc.stdout.splitlines()
            if line.startswith(head) and not line.endswith("/")
        )

    def delete_prefix(self, prefix: str) -> int:
        names = self.list_prefix(prefix)
        if names:
            self._run("rm", "-r", f"gs://{self.bucket}/{prefix}")
        return len(names)


class GcsClientStorage(Storage):
    """``google-cloud-storage`` Python-client backend, for hosts with the
    client library but no ``gsutil``. ``client`` may be injected; by
    default the library's ambient credentials are used."""

    def __init__(self, bucket: str, client=None):
        if not bucket:
            raise StorageError("GcsClientStorage requires a bucket name")
        if client is None:
            from google.cloud import storage as gcs  # noqa: PLC0415

            client = gcs.Client()
        self._bucket = client.bucket(bucket.rstrip("/"))

    def download_dataset(self, dataset_name: str, local_dir: Path) -> None:
        prefix = f"DATASET/{dataset_name}/"
        blobs = list(self._bucket.list_blobs(prefix=prefix))
        if not blobs:
            raise StorageError(f"Dataset not found in bucket: {prefix}")
        local_dir = Path(local_dir)
        if local_dir.exists():
            shutil.rmtree(local_dir)
        for b in blobs:
            if b.name.endswith("/"):
                continue
            dst = local_dir / b.name[len(prefix):]
            dst.parent.mkdir(parents=True, exist_ok=True)
            with_retry(
                lambda b=b, dst=dst: b.download_to_filename(str(dst)),
                what=f"download {b.name}",
            )

    def download_file(self, remote_rel: str, local_path: Path) -> None:
        local_path = Path(local_path)
        local_path.parent.mkdir(parents=True, exist_ok=True)
        blob = self._bucket.blob(remote_rel)
        with_retry(
            lambda: blob.download_to_filename(str(local_path)),
            what=f"download {remote_rel}",
        )

    def upload_tree(self, local_dir: Path, remote_rel: str) -> None:
        local_dir = Path(local_dir)
        for p in sorted(local_dir.rglob("*")):
            if p.is_file():
                rel = p.relative_to(local_dir)
                self.upload_file(p, f"{remote_rel}/{rel}")

    def upload_file(self, local_path: Path, remote_rel: str) -> None:
        blob = self._bucket.blob(remote_rel)
        with_retry(
            lambda: blob.upload_from_filename(str(local_path)),
            what=f"upload {remote_rel}",
        )

    def list_prefix(self, prefix: str) -> List[str]:
        return sorted(
            b.name
            for b in self._bucket.list_blobs(prefix=prefix)
            if not b.name.endswith("/")
        )

    def delete_prefix(self, prefix: str) -> int:
        blobs = [
            b for b in self._bucket.list_blobs(prefix=prefix)
            if not b.name.endswith("/")
        ]
        for b in blobs:
            with_retry(lambda b=b: b.delete(), what=f"delete {b.name}")
        return len(blobs)


def _gcs_client_available() -> bool:
    try:
        import google.cloud.storage  # noqa: F401, PLC0415

        return True
    except ImportError:
        return False


def storage_from_config(config: dict) -> Storage:
    """Pick a backend: with a bucket configured, gsutil when the CLI exists,
    else the google-cloud-storage client when importable; otherwise a local
    directory store under the framework home."""
    bucket = config.get("bucket") or ""
    if bucket:
        if shutil.which("gsutil"):
            return GsutilStorage(bucket)
        if _gcs_client_available():
            log.info("gsutil not found; using the google-cloud-storage client")
            return GcsClientStorage(bucket)
        log.warning(
            "Bucket %r configured but neither gsutil nor the "
            "google-cloud-storage client is available — using local storage",
            bucket,
        )
    from deepemia_tpu_torch.config.config import framework_home

    return LocalStorage(framework_home() / "bucket")
