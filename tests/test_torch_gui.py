"""The port's web panel (``deepemia_tpu_torch/gui/server.py``) against the
JAX package's (``deepemia_tpu/gui/server.py``): both serve on port 0 in
this process, each on its own home holding the same files, with the task
subprocess stubbed. The page (its name aside), ``/status``, ``/files``,
``/download`` (a path that escapes the output folder gets 404), ``/zip``,
``/storage_list`` and ``/storage_zip`` on a local storage root, ``/run``
(refusals and the command built, ``[python, main.py]`` mapped to the
port's ``[python, -m, deepemia_tpu_torch.cli.main]``), ``/upload_dataset``
with and without a wipe, and the password check must agree."""

import hashlib
import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import pytest
import torch

import deepemia_tpu.config.config as jax_cfg
import deepemia_tpu_torch.config.config as port_cfg
from deepemia_tpu.gui import server as jax_gui
from deepemia_tpu_torch.gui import server as port_gui

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_PREFIX = [sys.executable, "-m", "deepemia_tpu_torch.cli.main"]
PASSWORD = "s3cret pass"

OUTPUTS = {
    "measurements_results.csv": b"Image,Class\na.tif,0\n",
    "ds/a.tif_predictions.png": b"\x89PNG fake",
    "ds/notes.txt": b"notes",
    "logs/run.log": b"INFO ok\nWARNING careful\n",
    "ds/weights.bin": b"\0" * 64,
}
STORED = {
    "Archive/2026-01-01/run.log": b"a log",
    "Archive/2026-01-01/ds/m.csv": b"x,y\n1,2\n",
    "Archive/2026-01-02/m.csv": b"z\n",
    "DATASET/ds/keep.tif": b"old keep",
    "DATASET/ds/replace.tif": b"old replace",
}


class FakeProc:
    """A finished task: two lines of output, exit code 0."""

    def __init__(self, cmd, **kw):
        self.cmd, self.kw = list(cmd), kw
        self.stdout = io.StringIO("line one\nTask inference runs on cuda: card\n")

    def poll(self):
        return 0

    def wait(self):
        return 0


class Panel:
    """One package's panel on port 0 and the home it reads."""

    def __init__(self, gui, cfg_mod, home, monkeypatch):
        self.gui, self.cfg_mod, self.home, self.mp = gui, cfg_mod, home, monkeypatch
        for rel, data in OUTPUTS.items():
            (home / "output" / rel).parent.mkdir(parents=True, exist_ok=True)
            (home / "output" / rel).write_bytes(data)
        for rel, data in STORED.items():
            (home / "bucket" / rel).parent.mkdir(parents=True, exist_ok=True)
            (home / "bucket" / rel).write_bytes(data)
        monkeypatch.setattr(gui, "RUNNER", gui.TaskRunner())
        self.httpd = gui.serve("127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def _home(self):
        self.mp.setenv("DEEPEMIA_TPU_HOME", str(self.home))
        self.cfg_mod._default_store = None

    def get(self, path):
        """-> (status code, body bytes)."""
        self._home()
        try:
            with urllib.request.urlopen(self.base + path, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def post(self, path, body: bytes, ctype=None):
        self._home()
        req = urllib.request.Request(self.base + path, data=body, method="POST")
        if ctype:
            req.add_header("Content-Type", ctype)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def run(self, form: str):
        """POST /run with Popen stubbed -> (status, JSON, the commands)."""
        made = []

        def popen(cmd, **kw):
            made.append(FakeProc(cmd, **kw))
            return made[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(subprocess, "Popen", popen)
            code, obj = self.post("/run", form.encode())
            for _ in range(500 if made else 0):  # the output pump records the exit code
                if self.gui.RUNNER.history:
                    break
                threading.Event().wait(0.01)
        return code, obj, made

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.cfg_mod._default_store = None


@pytest.fixture()
def panels(monkeypatch, tmp_path):
    monkeypatch.delenv(port_gui.PASSWORD_ENV, raising=False)
    jax = Panel(jax_gui, jax_cfg, tmp_path / "jax", monkeypatch)
    port = Panel(port_gui, port_cfg, tmp_path / "port", monkeypatch)
    yield jax, port
    jax.close()
    port.close()


def _zip_contents(body):
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_page_matches_jax(panels):
    jax, port = panels
    (jc, jpage), (pc, ppage) = jax.get("/"), port.get("/index.html")
    assert jc == pc == 200
    assert ppage.decode() == jpage.decode().replace("deepEMIA-TPU", "deepEMIA")
    assert "deepEMIA control panel" in ppage.decode() and "TPU" not in ppage.decode()


@pytest.mark.parametrize("path", ["/status", "/files", "/nowhere", "/download?p=measurements_results.csv",
                                  "/download?p=ds/a.tif_predictions.png", "/download?p=ds/weights.bin",
                                  "/download?p=../../etc/passwd", "/download?p=..%2F..%2Fetc%2Fpasswd",
                                  "/download?p=%2Fetc%2Fpasswd", "/download?p=ds", "/download?p=missing.csv"])
def test_get_endpoints_match_jax(panels, path):
    jax, port = panels
    got, want = port.get(path), jax.get(path)
    assert got == want
    if "passwd" in path:
        assert got[0] == 404
    if path == "/files":
        assert json.loads(got[1]) == ["ds/a.tif_predictions.png", "ds/notes.txt", "logs/run.log",
                                      "measurements_results.csv"]


def test_zip_matches_jax(panels):
    jax, port = panels
    (jc, jbody), (pc, pbody) = jax.get("/zip"), port.get("/zip")
    assert jc == pc == 200
    assert _zip_contents(pbody) == _zip_contents(jbody) == {k: v for k, v in OUTPUTS.items()}


@pytest.mark.parametrize("prefix", ["Archive", "Archive/2026-01-01", "/DATASET/", "", "nothing", "../etc"])
def test_storage_endpoints_match_jax(panels, prefix):
    jax, port = panels
    q = urllib.request.quote(prefix)
    assert port.get(f"/storage_list?prefix={q}") == jax.get(f"/storage_list?prefix={q}")
    (jc, jbody), (pc, pbody) = jax.get(f"/storage_zip?prefix={q}"), port.get(f"/storage_zip?prefix={q}")
    assert pc == jc
    if pc == 200:
        assert _zip_contents(pbody) == _zip_contents(jbody)
        assert bool(_zip_contents(pbody)) == (prefix != "nothing")
    else:
        assert pbody == jbody


@pytest.mark.parametrize("form, error", [
    ("task=evil&dataset=x&password=", "unknown task 'evil'"),
    ("task=inference&dataset=bad/name&password=", "invalid dataset name"),
    ("task=inference&dataset=&password=", "invalid dataset name"),
])
def test_run_refusals_match_jax(panels, form, error):
    jax, port = panels
    want, got = jax.run(form), port.run(form)
    assert got[:2] == want[:2] == (200, {"error": error})
    assert not got[2] and not want[2]


@pytest.mark.parametrize("form", [
    "task=inference&dataset=ds&password=&flags=--visualize+--no-download",
    "task=train&dataset=my_ds-2&flags=--augment+--optimize+--rm+-rf+--no-upload",
    "task=evaluate&dataset=ds&flags=--visualize+--id+--no-gpu-check",
    "task=prepare&dataset=ds",
])
def test_run_builds_the_jax_command(panels, form):
    jax, port = panels
    (jc, jobj, jmade), (pc, pobj, pmade) = jax.run(form), port.run(form)
    assert jc == pc == 200 and jobj == pobj == {"ok": True}
    (jproc,), (pproc,) = jmade, pmade
    assert Path(jproc.cmd[1]).name == "main.py" and jproc.cmd[0] == sys.executable
    assert pproc.cmd == PORT_PREFIX + jproc.cmd[2:] and "--no-gpu-check" in pproc.cmd
    assert pproc.kw["env"]["PYTHONPATH"].startswith(str(ROOT))
    assert {k: v for k, v in pproc.kw.items() if k != "env"} == jproc.kw

    def status(panel):
        s = json.loads(panel.get("/status")[1])
        for h in s["history"]:
            h.pop("seconds")
        return s

    assert status(port) == status(jax)
    assert status(port)["history"][-1]["rc"] == 0 and "line one" in status(port)["tail"]
    # one task at a time: a second start while one runs is refused by both
    jax.gui.RUNNER.proc.poll = port.gui.RUNNER.proc.poll = lambda: None
    assert port.run(form)[:2] == jax.run(form)[:2] == (200, {"error": "a task is already running"})


def test_password_matches_jax(panels, monkeypatch):
    jax, port = panels
    monkeypatch.setenv(port_gui.PASSWORD_ENV, hashlib.sha256(PASSWORD.encode()).hexdigest().upper())
    for pw in (PASSWORD, "wrong", "", PASSWORD + " "):
        assert port_gui.verify_admin_password(pw) == jax_gui.verify_admin_password(pw) == (pw == PASSWORD)
    bad = "task=inference&dataset=ds&password=wrong"
    assert port.run(bad)[:2] == jax.run(bad)[:2] == (403, {"error": "invalid password"})
    good = "task=inference&dataset=ds&password=" + urllib.request.quote(PASSWORD)
    assert port.run(good)[:2] == jax.run(good)[:2] == (200, {"ok": True})
    monkeypatch.delenv(port_gui.PASSWORD_ENV)
    assert port_gui.verify_admin_password("anything") and jax_gui.verify_admin_password("anything")


def _multipart(fields, files):
    boundary = "deepemiaBOUNDARY"
    out = b""
    for k, v in fields.items():
        out += f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
    for name, data in files:
        out += (f'--{boundary}\r\nContent-Disposition: form-data; name="files"; filename="{name}"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n").encode() + data + b"\r\n"
    return out + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("wipe", ["", "1"])
def test_upload_dataset_matches_jax(panels, monkeypatch, wipe):
    jax, port = panels
    monkeypatch.setenv(port_gui.PASSWORD_ENV, hashlib.sha256(PASSWORD.encode()).hexdigest())
    files = [("replace.tif", b"new replace"), ("../sub/new.png", b"\x89PNG new")]
    refused = (({"dataset": "ds", "password": "wrong"}, None), ({"dataset": "b/d", "password": PASSWORD}, None),
               ({"dataset": "ds", "password": PASSWORD}, "text/plain"))
    for fields, ctype in refused:
        body, mp_ctype = _multipart(fields, files)
        assert port.post("/upload_dataset", body, ctype or mp_ctype) == jax.post("/upload_dataset", body,
                                                                                  ctype or mp_ctype)
    body, ctype = _multipart({"dataset": "ds", "password": PASSWORD, "wipe": wipe}, [])
    assert port.post("/upload_dataset", body, ctype) == jax.post("/upload_dataset", body, ctype) == (
        400, {"error": "no files"})
    body, ctype = _multipart({"dataset": "ds", "password": PASSWORD, "wipe": wipe}, files)
    got, want = port.post("/upload_dataset", body, ctype), jax.post("/upload_dataset", body, ctype)
    assert got == want == (200, {"ok": True, "uploaded": 2, "wiped": bool(wipe)})
    ptree, jtree = _tree(port.home / "bucket"), _tree(jax.home / "bucket")
    assert ptree == jtree
    assert jtree["DATASET/ds/replace.tif"] == b"new replace" and jtree["DATASET/ds/new.png"] == b"\x89PNG new"
    assert ("DATASET/ds/keep.tif" in jtree) == (not wipe)
