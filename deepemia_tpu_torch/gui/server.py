"""Web control panel (stdlib ``http.server``): the JAX package's
``deepemia_tpu/gui/server.py`` for the port.

    python -m deepemia_tpu_torch.gui.server [--host 127.0.0.1] [--port 8080]

GET / renders the panel; POST /run starts one task at a time (``TaskRunner``:
the task and flag whitelists, the ETA from the ETA store, the last 400 lines
of output, the history), as ``python -m deepemia_tpu_torch.cli.main
--no-gpu-check`` in its own interpreter (``cli.task_command``), which runs
on ``cuda`` and logs the device it resolved; /status, /files, /zip and
/download (path-guarded) read the local results, /storage_list and
/storage_zip the storage backend, and POST /upload_dataset takes a multipart
upload into ``DATASET/<name>/``, optionally replacing the folder. With
``DEEPEMIA_ADMIN_PASSWORD_SHA256`` set, /run and /upload_dataset need the
password whose SHA-256 it holds.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

from deepemia_tpu_torch.cli import task_command
from deepemia_tpu_torch.config.config import get_config
from deepemia_tpu_torch.utils.eta import estimate_eta

log = logging.getLogger("deepemia_tpu_torch.gui")

PASSWORD_ENV = "DEEPEMIA_ADMIN_PASSWORD_SHA256"
ALLOWED_TASKS = ("prepare", "train", "evaluate", "inference")


def verify_admin_password(password: str) -> bool:
    """SHA-256 compare against ``DEEPEMIA_ADMIN_PASSWORD_SHA256``; with no
    password configured, access is open."""
    expected = os.environ.get(PASSWORD_ENV, "")
    if not expected:
        return True
    return hashlib.sha256(password.encode()).hexdigest() == expected.lower()


class TaskRunner:
    """At most one task subprocess at a time."""

    def __init__(self):
        self.proc: Optional[subprocess.Popen] = None
        self.task: Optional[str] = None
        self.dataset: Optional[str] = None
        self.started: float = 0.0
        self.eta: float = 0.0
        self.history: List[Dict] = []
        self.lock = threading.Lock()
        self.output_tail: List[str] = []

    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def start(self, task: str, dataset: str, extra_flags: List[str]) -> str:
        with self.lock:
            if self.running():
                return "a task is already running"
            if task not in ALLOWED_TASKS:
                return f"unknown task {task!r}"
            if not dataset or not dataset.replace("_", "").replace("-", "").isalnum():
                return "invalid dataset name"
            allowed_flags = {
                "--augment", "--optimize", "--visualize", "--id",
                "--no-gpu-check", "--no-download", "--no-upload",
            }
            flags = [f for f in extra_flags if f in allowed_flags]
            cmd, env = task_command(["--task", task, "--dataset_name", dataset, "--no-gpu-check", *flags])
            cfg = get_config()
            try:
                n_img = 1
                if task == "inference":
                    home = Path(os.path.expanduser(cfg["paths"].get("local_dataset_root", "~")))
                    root = home / "DATASET" / "INFERENCE"
                    n_img = len(list(root.glob("*"))) if root.exists() else 1
                self.eta = estimate_eta(cfg["paths"]["eta_file"], task, n_img)
            except Exception:  # noqa: BLE001 - an ETA is a hint; the task starts without one
                self.eta = 60.0
            self.output_tail = []
            self.proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.task, self.dataset, self.started = task, dataset, time.time()
            threading.Thread(target=self._pump, daemon=True).start()
            return ""

    def _pump(self):
        proc = self.proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            self.output_tail.append(line.rstrip())
            del self.output_tail[:-400]
        rc = proc.wait()
        self.history.append(
            {"task": self.task, "dataset": self.dataset, "rc": rc, "seconds": round(time.time() - self.started, 1)}
        )

    def status(self) -> Dict:
        elapsed = time.time() - self.started if self.started else 0.0
        return {
            "running": self.running(),
            "task": self.task,
            "dataset": self.dataset,
            "elapsed": round(elapsed, 1) if self.running() else 0.0,
            "eta": round(self.eta, 1),
            "progress": min(elapsed / self.eta, 0.99) if self.running() and self.eta else 0.0,
            "history": self.history[-10:],
            "tail": self.output_tail[-40:],
        }


RUNNER = TaskRunner()

PAGE = """<!DOCTYPE html>
<html><head><title>deepEMIA</title><style>
body{font-family:system-ui,sans-serif;margin:2rem;max-width:70rem}
fieldset{margin-bottom:1rem;border:1px solid #ccc;border-radius:6px}
progress{width:100%}
pre{background:#111;color:#9e9;padding:.7rem;overflow:auto;max-height:20rem;font-size:.8rem}
.warn{color:#b60}.err{color:#c22}
table{border-collapse:collapse}td,th{border:1px solid #ccc;padding:.2rem .6rem}
</style></head><body>
<h1>deepEMIA control panel</h1>
<fieldset><legend>Run a task</legend>
<form id="runform">
  Task: <select name="task"><option>inference</option><option>train</option>
  <option>evaluate</option><option>prepare</option></select>
  Dataset: <input name="dataset" placeholder="dataset name">
  Password: <input name="password" type="password">
  <label><input type="checkbox" name="flags" value="--visualize" checked>visualize</label>
  <label><input type="checkbox" name="flags" value="--augment">augment</label>
  <label><input type="checkbox" name="flags" value="--optimize">HPO</label>
  <label><input type="checkbox" name="flags" value="--no-download" checked>local only</label>
  <button>Start</button> <span id="runmsg"></span>
</form>
<div id="prog" style="display:none">
  <p><b id="ptask"></b> <span id="pelapsed"></span></p>
  <progress id="pbar" value="0" max="1"></progress>
</div></fieldset>
<fieldset><legend>Live output / logs</legend><pre id="logbox">(idle)</pre></fieldset>
<fieldset><legend>Task history</legend><table id="hist"><tr><th>task</th>
<th>dataset</th><th>exit</th><th>seconds</th></tr></table></fieldset>
<fieldset><legend>Results browser</legend>
<p><a href="zip">Download everything as results.zip</a></p>
<div id="files"></div></fieldset>
<fieldset><legend>Storage: upload dataset</legend>
<form id="upform">
  Dataset: <input name="dataset" placeholder="dataset name">
  Password: <input name="password" type="password">
  <label><input type="checkbox" name="wipe" value="1">replace folder contents</label>
  <input type="file" name="files" multiple>
  <button>Upload</button> <span id="upmsg"></span>
</form></fieldset>
<fieldset><legend>Storage: archive browser</legend>
<form id="lsform">
  Prefix: <input name="prefix" value="Archive">
  <button>List</button>
</form>
<div id="storefiles"></div></fieldset>
<script>
async function refresh(){
  const s = await (await fetch('status')).json();
  document.getElementById('prog').style.display = s.running ? '' : 'none';
  if(s.running){
    document.getElementById('ptask').textContent = s.task+' @ '+s.dataset;
    document.getElementById('pelapsed').textContent =
      s.elapsed+'s / ~'+s.eta+'s';
    document.getElementById('pbar').value = s.progress;
  }
  const box = document.getElementById('logbox');
  box.innerHTML = (s.tail||[]).map(l=>{
    const e = l.replace(/&/g,'&amp;').replace(/</g,'&lt;');
    if(/ERROR|CRITICAL/.test(l)) return '<span class="err">'+e+'</span>';
    if(/WARNING/.test(l)) return '<span class="warn">'+e+'</span>';
    return e;
  }).join('\\n') || '(idle)';
  const h = document.getElementById('hist');
  while(h.rows.length>1)h.deleteRow(1);
  for(const r of (s.history||[])){
    const row=h.insertRow();
    for(const k of ['task','dataset','rc','seconds'])
      row.insertCell().textContent=r[k];
  }
  const files = await (await fetch('files')).json();
  document.getElementById('files').innerHTML = files.map(f=>
    '<a href="download?p='+encodeURIComponent(f)+'">'+f+'</a>').join('<br>');
}
setInterval(refresh, 2000); refresh();
document.getElementById('runform').onsubmit = async (ev)=>{
  ev.preventDefault();
  const fd = new FormData(ev.target);
  const flags=[...ev.target.querySelectorAll('input[name=flags]:checked')].map(c=>c.value);
  const body = new URLSearchParams({task:fd.get('task'),dataset:fd.get('dataset'),
    password:fd.get('password')||'',flags:flags.join(' ')});
  const r = await (await fetch('run',{method:'POST',body})).json();
  document.getElementById('runmsg').textContent = r.error||'started';
};
document.getElementById('upform').onsubmit = async (ev)=>{
  ev.preventDefault();
  const fd = new FormData(ev.target);
  const r = await (await fetch('upload_dataset',{method:'POST',body:fd})).json();
  document.getElementById('upmsg').textContent =
    r.error || ('uploaded '+r.uploaded+(r.wiped?' (folder replaced)':''));
};
document.getElementById('lsform').onsubmit = async (ev)=>{
  ev.preventDefault();
  const prefix = new FormData(ev.target).get('prefix')||'';
  const r = await (await fetch('storage_list?prefix='+
    encodeURIComponent(prefix))).json();
  const el = document.getElementById('storefiles');
  if(r.error){el.textContent = r.error; return;}
  el.innerHTML =
    '<p><a href="storage_zip?prefix='+encodeURIComponent(prefix)+
    '">Download '+prefix+'.zip</a></p>' +
    (r.folders||[]).map(f=>'<b>'+f+'/</b>').join('<br>') + '<br>' +
    (r.files||[]).map(f=>f).join('<br>');
};
</script></body></html>
"""


class Handler(BaseHTTPRequestHandler):
    server_version = "deepemia/0.1"

    def _send(self, code: int, body: bytes, ctype: str = "text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _output_dir(self) -> Path:
        cfg = get_config()
        return Path(os.path.expanduser(cfg["paths"]["output_dir"]))

    def _storage(self):
        from deepemia_tpu_torch.utils.storage import storage_from_config

        return storage_from_config(get_config())

    def _send_zip(self, body: bytes, filename: str):
        self.send_response(200)
        self.send_header("Content-Type", "application/zip")
        self.send_header(
            "Content-Disposition", f"attachment; filename={filename}"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        url = urllib.parse.urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._send(200, PAGE.encode())
        elif url.path == "/status":
            self._json(RUNNER.status())
        elif url.path == "/files":
            out = self._output_dir()
            files = []
            if out.exists():
                for p in sorted(out.rglob("*")):
                    if p.is_file() and p.suffix.lower() in (
                        ".csv", ".png", ".jpg", ".txt", ".log"
                    ):
                        files.append(str(p.relative_to(out)))
            self._json(files[:200])
        elif url.path == "/zip":
            # zip of the whole results tree, from the local output dir
            import io
            import zipfile

            out = self._output_dir()
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                if out.exists():
                    for p in sorted(out.rglob("*")):
                        if p.is_file() and p.stat().st_size < 64 * 1024 * 1024:
                            z.write(p, p.relative_to(out))
            self._send_zip(buf.getvalue(), "results.zip")
        elif url.path == "/storage_list":
            # folder browsing on the storage backend
            q = urllib.parse.parse_qs(url.query)
            prefix = q.get("prefix", [""])[0].strip("/")
            if ".." in prefix:
                self._json({"error": "invalid prefix"}, 400)
                return
            try:
                files = self._storage().list_prefix(prefix)[:500]
            except Exception as e:  # noqa: BLE001 - surface as JSON error
                self._json({"error": str(e)}, 500)
                return
            # top-level folder names first, then the files themselves,
            # which zip and download act on
            folders = sorted(
                {
                    f[len(prefix) :].lstrip("/").split("/")[0]
                    for f in files
                    if "/" in f[len(prefix) :].lstrip("/")
                }
            )
            self._json({"prefix": prefix, "folders": folders, "files": files})
        elif url.path == "/storage_zip":
            # zip an archive folder straight from the storage backend
            import io
            import tempfile
            import zipfile

            q = urllib.parse.parse_qs(url.query)
            prefix = q.get("prefix", [""])[0].strip("/")
            if not prefix or ".." in prefix:
                self._json({"error": "invalid prefix"}, 400)
                return
            try:
                store = self._storage()
                files = store.list_prefix(prefix)[:500]
                buf = io.BytesIO()
                with tempfile.TemporaryDirectory() as td, zipfile.ZipFile(
                    buf, "w", zipfile.ZIP_DEFLATED
                ) as z:
                    for i, rel in enumerate(files):
                        local = Path(td) / str(i)
                        store.download_file(rel, local)
                        arc = rel[len(prefix) :].lstrip("/") or Path(rel).name
                        z.write(local, arc)
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, 500)
                return
            name = prefix.rstrip("/").rsplit("/", 1)[-1] or "archive"
            self._send_zip(buf.getvalue(), f"{name}.zip")
        elif url.path == "/download":
            q = urllib.parse.parse_qs(url.query)
            rel = q.get("p", [""])[0]
            out = self._output_dir().resolve()
            target = (out / rel).resolve()
            try:
                target.relative_to(out)  # raises on escape (exact ancestry)
            except ValueError:
                self._json({"error": "not found"}, 404)
                return
            if not target.is_file():
                self._json({"error": "not found"}, 404)
                return
            ctype = {
                ".png": "image/png",
                ".jpg": "image/jpeg",
                ".csv": "text/csv",
            }.get(target.suffix.lower(), "application/octet-stream")
            self._send(200, target.read_bytes(), ctype)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        url = urllib.parse.urlparse(self.path)
        length = int(self.headers.get("Content-Length", "0"))
        if url.path == "/upload_dataset":
            self._upload_dataset(length)
            return
        form = urllib.parse.parse_qs(self.rfile.read(length).decode())
        if url.path != "/run":
            self._json({"error": "not found"}, 404)
            return
        if not verify_admin_password(form.get("password", [""])[0]):
            self._json({"error": "invalid password"}, 403)
            return
        err = RUNNER.start(
            form.get("task", [""])[0],
            form.get("dataset", [""])[0],
            form.get("flags", [""])[0].split(),
        )
        self._json({"error": err} if err else {"ok": True})

    def _upload_dataset(self, length: int):
        """Multipart dataset upload into ``DATASET/<name>/`` on the storage
        backend, with optional wipe of the existing folder."""
        import email
        import email.policy
        import tempfile

        if length > 512 * 1024 * 1024:
            self._json({"error": "upload too large"}, 413)
            return
        ctype = self.headers.get("Content-Type", "")
        if "multipart/form-data" not in ctype:
            self._json({"error": "multipart/form-data required"}, 400)
            return
        raw = self.rfile.read(length)
        msg = email.message_from_bytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + raw,
            policy=email.policy.default,
        )
        fields: Dict[str, str] = {}
        uploads: List = []  # (filename, bytes)
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            filename = part.get_filename()
            payload = part.get_payload(decode=True) or b""
            if filename:
                uploads.append((Path(filename).name, payload))
            elif name:
                fields[name] = payload.decode(errors="replace").strip()
        if not verify_admin_password(fields.get("password", "")):
            self._json({"error": "invalid password"}, 403)
            return
        dataset = fields.get("dataset", "")
        if not dataset or not dataset.replace("_", "").replace("-", "").isalnum():
            self._json({"error": "invalid dataset name"}, 400)
            return
        if not uploads:
            self._json({"error": "no files"}, 400)
            return
        wipe = fields.get("wipe", "") in ("1", "true", "on", "yes")
        try:
            store = self._storage()
            with tempfile.TemporaryDirectory() as td:
                for fname, payload in uploads:
                    (Path(td) / fname).write_bytes(payload)
                dest = f"DATASET/{dataset}"
                if wipe:
                    store.upload_tree_wipe(Path(td), dest)
                else:
                    # merge into the existing folder: per-file upload keeps
                    # files that are not being replaced
                    for fname, _ in uploads:
                        store.upload_file(Path(td) / fname, f"{dest}/{fname}")
        except Exception as e:  # noqa: BLE001
            self._json({"error": str(e)}, 500)
            return
        self._json({"ok": True, "uploaded": len(uploads), "wiped": wipe})

    def log_message(self, fmt, *args):  # quieter default
        log.debug("gui: " + fmt, *args)


def serve(host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((host, port), Handler)
    log.info("GUI listening on http://%s:%d", host, port)
    return httpd


def cli_entry() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="deepEMIA web control panel")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    httpd = serve(args.host, args.port)
    print(f"deepEMIA panel: http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    cli_entry()
