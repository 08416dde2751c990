"""Write ``tests/data/torch_avif_fixtures.npz``: AVIF files and what
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0, libavif and libaom
3.14) reads from each, for ``tests/test_torch_avif.py`` and
``chip_smoke.py`` phase 21.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array, ``<name>/sha256`` the SHA-256 of its bytes (arrays of more
than 64x64 pixels, and phase 21's files), or ``<name>/none`` where cv2
returns None; ``<name>/named`` the words with which the port refuses a
form it does not decode (``NAMED``); ``<name>/cdef`` (empty) marks a form
the port once refused and now reads (``CDEF``: cv2's lossy 4:2:0 at
quality 75, which applies CDEF); ``<name>/segmentation`` (empty) a header
rewrite the port once refused by name for switching segmentation on, and
now fails on as cv2 does (``SEGMENTATION``); ``c12/sha256`` holds the SHA-256 of
cv2's array (zeros for None) for each of the 800 damaged or cut C11
TIFFs of ``c12_copies``. The lossless AV1 payloads come
from ``cv2.imencode('.avif', img, [IMWRITE_AVIF_QUALITY, 100])``; the box
writer here (``avif``) puts them in the container forms a reader meets
(``iloc`` versions and construction methods, extents, ``idat``, the
transform properties, an alpha item, unknown properties); ``rewrite``
and ``resize`` change the AV1 headers (screen content, film grain, the
frame size).

    python tools/make_torch_avif_fixtures.py

needs cv2; it is deterministic.
"""

from __future__ import annotations

import hashlib
import io
import struct
import tempfile
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "tests" / "data" / "torch_avif_fixtures.npz"
# the forms cv2 reads (or, for a header rewritten to switch a tool on, fails on) that the port refuses by
# name: fixture -> the words of its UnsupportedImageError
NAMED = {
    "refused-sequence": "an image sequence",
    "refused-grid": "a grid image",
    "box-premultiplied-alpha": "premultiplied alpha",
    "box-ispe-scaled": "which libavif scales",
    "box-film-grain": "AV1 film grain",
}
# the forms the port refused by name until it applied CDEF, and reads now (each keeps its name)
CDEF = ("refused-lossy-420",)
# screen content tools set in place: the frame header's next two bits, read now as force_integer_mv and
# allow_intrabc, come from its other fields and switch intra block copy on; the fields after them, shifted, switch
# segmentation on. The port refused it by name until it parsed segmentation; libaom, and the port now, fail on the
# rest of the stream
SEGMENTATION = ("box-screen-content",)


# ---------------------------------------------------------------------------
# ISO BMFF boxes
# ---------------------------------------------------------------------------


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, struct.pack(">I", version << 24 | flags) + body)


def parse_boxes(data: bytes, pos: int = 0, end: int = None) -> list:
    """[(type, body start, body end)] of the boxes of data[pos:end]."""
    end = len(data) if end is None else end
    out = []
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8 : pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        out.append((kind, pos + head, pos + size))
        pos += size
    return out


def cv2_payload(img: np.ndarray, *params) -> bytes:
    """The AV1 payload (OBUs) of the primary item of a file cv2 writes, and
    its av1C box body -> (payload, av1C body, colr body)."""
    data = cv2_file(img, *params)
    return payload_of(data)


def cv2_file(img: np.ndarray, *params) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 100, *params])
    assert ok
    return buf.tobytes()


def payload_of(data: bytes):
    """-> (the primary item's AV1 payload, its av1C body, its colr body) of
    a file as cv2 writes it (one item, iloc version 0)."""
    (meta,) = [b for b in parse_boxes(data) if b[0] == b"meta"]
    kids = {k: (s, e) for k, s, e in parse_boxes(data, meta[1] + 4, meta[2])}
    s, e = kids[b"iloc"]
    body = data[s + 4 : e]
    sizes = body[0] << 8 | body[1]
    assert sizes == 0x4400, hex(sizes)
    (count,) = struct.unpack(">H", body[2:4])
    item, _, extents = struct.unpack(">HHH", body[4:10])
    payload = b"".join(data[o : o + n] for o, n in (struct.unpack(">II", body[10 + 8 * k : 18 + 8 * k])
                                                      for k in range(extents)))
    (ipco,) = [b for b in parse_boxes(data, *kids[b"iprp"]) if b[0] == b"ipco"]
    sub = {k: data[s2:e2] for k, s2, e2 in parse_boxes(data, ipco[1], ipco[2])}
    return payload, sub[b"av1C"], sub.get(b"colr")


def avif(items: list, primary: int = 1, brands=(b"avif", b"mif1", b"miaf"), major: bytes = b"avif",
         iloc_version: int = 0, sizes=(4, 4, 0, 0), iinf_version: int = 0, infe_version: int = 2,
         ipma_version: int = 0, ipma_flags: int = 0, refs: list = (), extra_boxes: bytes = b"",
         mdat_first: bool = False, pitm_version: int = 0, meta_extra: bytes = b"", hdlr: bytes = b"pict") -> bytes:
    """An AVIF file of ``items``: each a dict with ``id``, ``type`` (4 bytes),
    ``data`` (the payload), ``props`` ([(box bytes, essential)]), and
    optionally ``extents`` (byte counts splitting the payload),
    ``method`` (1: in ``idat``), ``name``. ``sizes``: iloc's offset,
    length, base offset and index sizes; ``refs``: [(type, from, [to])]."""
    ftyp = box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    hdlr_box = full(b"hdlr", 0, 0, b"\0" * 4 + hdlr + b"\0" * 12 + b"\0")
    pitm = full(b"pitm", pitm_version, 0, struct.pack(">I" if pitm_version else ">H", primary))
    wide = iinf_version != 0
    infes = b"".join(full(b"infe", infe_version, 0, struct.pack(">I" if infe_version >= 3 else ">H", it["id"])
                          + b"\0\0" + it["type"] + it.get("name", b"") + b"\0") for it in items)
    iinf = full(b"iinf", iinf_version, 0, struct.pack(">I" if wide else ">H", len(items)) + infes)
    # properties: one ipco list, each item's associations by index (1-based)
    ipco, assoc = [], []
    for it in items:
        a = []
        for prop, essential in it.get("props", []):
            if prop not in ipco:
                ipco.append(prop)
            a.append((ipco.index(prop) + 1, essential))
        assoc.append(a)
    big_index = ipma_flags & 1
    ipma_body = struct.pack(">I", len(items))
    for it, a in zip(items, assoc):
        ipma_body += struct.pack(">I" if ipma_version else ">H", it["id"]) + bytes([len(a)])
        for idx, ess in a:
            ipma_body += struct.pack(">H", ess << 15 | idx) if big_index else bytes([ess << 7 | idx])
    iprp = box(b"iprp", box(b"ipco", b"".join(ipco)) + full(b"ipma", ipma_version, ipma_flags, ipma_body))
    iref = b""
    if refs:
        iref = full(b"iref", 0, 0, b"".join(box(t, struct.pack(">HH", f, len(to)) + b"".join(struct.pack(">H", x)
                                                                                         for x in to))
                                         for t, f, to in refs))
    idat_data = b"".join(it["data"] for it in items if it.get("method") == 1)
    idat = box(b"idat", idat_data) if idat_data else b""
    off_size, len_size, base_size, index_size = sizes

    def iloc_body(mdat_at: int) -> bytes:
        body = bytes([off_size << 4 | len_size, base_size << 4 | (index_size if iloc_version else 0)])
        body += struct.pack(">I" if iloc_version == 2 else ">H", len(items))
        at, idat_at = mdat_at, 0
        for it in items:
            body += struct.pack(">I" if iloc_version == 2 else ">H", it["id"])
            method = it.get("method", 0)
            if iloc_version:
                body += struct.pack(">H", method)
            body += struct.pack(">H", 0)  # data_reference_index
            data = it["data"]
            cuts = it.get("extents") or [len(data)]
            start = idat_at if method == 1 else at
            base = (start if not off_size else min(it.get("base", 0), start)) if base_size else 0
            if base_size:
                body += base.to_bytes(base_size, "big")
            body += struct.pack(">H", len(cuts))
            pos = 0
            for n in cuts:
                if iloc_version and index_size:
                    body += (0).to_bytes(index_size, "big")
                body += (start + pos - base).to_bytes(off_size, "big") if off_size else b""
                body += n.to_bytes(len_size, "big") if len_size else b""
                pos += n
            if method == 1:
                idat_at += len(data)
            else:
                at += len(data)
        return body

    def build(mdat_at: int) -> bytes:
        meta = full(b"meta", 0, 0, hdlr_box + pitm + full(b"iloc", iloc_version, 0, iloc_body(mdat_at)) + iinf
                    + iprp + (iref if refs else b"") + idat + meta_extra)
        return meta

    mdat_payload = b"".join(it["data"] for it in items if it.get("method", 0) == 0)
    if mdat_first:
        mdat_at = len(ftyp) + 8
        return ftyp + box(b"mdat", mdat_payload) + build(mdat_at) + extra_boxes
    meta = build(1 << 20)  # the offsets' widths are fixed: a first pass sizes the meta box
    mdat_at = len(ftyp) + len(meta) + len(extra_boxes) + 8
    meta = build(mdat_at)
    return ftyp + meta + extra_boxes + box(b"mdat", mdat_payload)


def ispe(w: int, h: int) -> bytes:
    return full(b"ispe", 0, 0, struct.pack(">II", w, h))


def pixi(depth: int, channels: int) -> bytes:
    return full(b"pixi", 0, 0, bytes([channels] + [depth] * channels))


def colr_nclx(cp: int, tc: int, mc: int, full_range: int) -> bytes:
    return box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc, full_range << 7))


def image_item(payload: bytes, av1c: bytes, w: int, h: int, depth: int, channels: int, colr: bytes = None,
               item_id: int = 1, extra=(), **kw) -> dict:
    props = [(ispe(w, h), False), (pixi(depth, channels), False), (box(b"av1C", av1c), True)]
    if colr is not None:
        props.append((colr if colr.startswith(struct.pack(">I", len(colr))) else box(b"colr", colr), False))
    props += list(extra)
    return dict(id=item_id, type=b"av01", data=payload, props=props, **kw)


# ---------------------------------------------------------------------------
# Images and AV1 header rewrites
# ---------------------------------------------------------------------------


def texture(h: int, w: int, seed: int, channels: int = 3, depth: int = 8) -> np.ndarray:
    """A test image that takes every intra tool: smooth waves (directional
    and smooth modes, CFL), flat patches (DC, filter intra), hard edges
    (Paeth) and a little noise -> [h,w] or [h,w,3] of ``depth`` bits."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 128 + 70 * np.sin(x / (6 + 3 * c) + y / (11 + c) + c) * np.cos(y / (8 + 2 * c))
    img[h // 3 : h // 2, w // 4 :] = (40, 200, 90)
    img[:, (3 * w) // 4 :] *= 0.5
    img += rng.normal(0, 3, img.shape)
    v = np.clip(img / 255 * ((1 << depth) - 1), 0, (1 << depth) - 1).round()
    v = v.astype(np.uint8 if depth == 8 else np.uint16)
    return v[..., 0] if channels == 1 else v


def particles(size: int, seed: int) -> np.ndarray:
    """A size x size gray micrograph of 300 dark round particles on 170,
    without noise (tools/make_torch_container_fixtures.py's, less its
    noise: ~460 KB as lossless AVIF at 2048²)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.full((size, size), 170.0)
    for _ in range(300):
        cy, cx = rng.random(2) * size
        r = 6 + 40 * rng.random()
        y0, y1 = max(int(cy - 3 * r), 0), min(int(cy + 3 * r) + 1, size)
        x0, x1 = max(int(cx - 3 * r), 0), min(int(cx + 3 * r) + 1, size)
        d2 = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
        img[y0:y1, x0:x1] -= 90 * np.exp(-d2 / (2 * (0.6 * r) ** 2))
    return np.clip(img, 0, 255).round().astype(np.uint8)


def _obus(payload: bytes) -> list:
    """[(type, start of the OBU, start of its body, end)] of a payload whose
    OBUs carry sizes and no extension."""
    out, at = [], 0
    while at < len(payload):
        head = payload[at]
        pos, size, shift = at + 1, 0, 0
        while True:
            b = payload[pos]
            size |= (b & 0x7F) << shift
            pos, shift = pos + 1, shift + 7
            if not b & 0x80:
                break
        out.append((head >> 3 & 15, at, pos, pos + size))
        at = pos + size
    return out


def _set_bit(data: bytearray, bit: int) -> None:
    data[bit >> 3] |= 0x80 >> (bit & 7)


def rewrite(payload: bytes, change: str) -> bytes:
    """A cv2-written lossless payload (a reduced still picture header) with
    header bits set in place: ``screen`` sets allow_screen_content_tools
    (the frame header's second bit); ``grain`` sets
    film_grain_params_present (the sequence header's last bit before its
    trailing one), then apply_grain, the first bit after the frame header,
    where its byte alignment was (``tools/av1_headers.py`` reads the
    header to its end)."""
    data = bytearray(payload)
    obus = {t: (s, e) for t, _, s, e in _obus(payload)}
    frame_start = obus[6][0]
    if change == "screen":
        _set_bit(data, frame_start * 8 + 1)
        return bytes(data)
    assert change == "grain", change
    end = _tool("av1_headers").fields(payload)["bit_end"]
    assert end % 8, "no byte alignment after the frame header to hold apply_grain"
    s, e = obus[1]
    last = max(k for k in range(s * 8, e * 8) if data[k >> 3] & (0x80 >> (k & 7)))  # the trailing one
    _set_bit(data, last - 1)
    _set_bit(data, frame_start * 8 + end)
    return bytes(data)


def resize(payload: bytes, width: int, height: int) -> bytes:
    """A cv2-written payload (a reduced still picture header) with its
    sequence header's frame size rewritten to ``width`` x ``height`` in
    16-bit fields; the frame OBU is left as it was."""
    _, at, s, e = next(o for o in _obus(payload) if o[0] == 1)
    bits = "".join(f"{b:08b}" for b in payload[s:e])
    wb, hb = int(bits[10:14], 2) + 1, int(bits[14:18], 2) + 1
    rest = bits[18 + wb + hb : bits.rindex("1")]  # up to the trailing one
    new = bits[:10] + f"{15:04b}{15:04b}{width - 1:016b}{height - 1:016b}" + rest + "1"
    new += "0" * (-len(new) % 8)
    body = int(new, 2).to_bytes(len(new) // 8, "big")
    assert len(body) < 128
    return payload[: at + 1] + bytes([len(body)]) + body + payload[e:]


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def _tool(name):
    """``tools/<name>.py`` beside this file, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def c12_copies(fixtures) -> list:
    """The seeded fuzz of C12 over the C11 TIFFs of
    ``tests/data/torch_jpeg2000_fixtures.npz`` (``fixtures``, loaded):
    for each, 24 copies with one byte past the first 16 XORed with a
    random non-zero value, then cuts at eight fractions -> [(name, bytes)],
    800 in all."""
    names = sorted({k.split("/")[0] for k in fixtures.files if k.startswith("c11-")})
    out = []
    for i, name in enumerate(names):
        data = fixtures[f"{name}/file"].tobytes()
        rng = np.random.default_rng(1000 + i)
        for j in range(24):
            b = bytearray(data)
            k = int(rng.integers(16, len(data)))
            b[k] ^= int(rng.integers(1, 256))
            out.append((f"{name}/damaged-{j:02d}", bytes(b)))
        out += [(f"{name}/cut-{frac}", data[: len(data) * frac // 100]) for frac in (10, 25, 40, 55, 70, 85, 95, 99)]
    return out


def _without_times(data: bytes) -> bytes:
    """An animation's bytes with the creation and modification times of
    its mvhd, tkhd and mdhd boxes zeroed (cv2 writes the clock's)."""
    out = bytearray(data)

    def walk(pos, end):
        for kind, s, e in parse_boxes(data, pos, end):
            if kind in (b"moov", b"trak", b"mdia"):
                walk(s, e)
            elif kind in (b"mvhd", b"tkhd", b"mdhd"):
                width = 8 if data[s] == 1 else 4
                out[s + 4 : s + 4 + 2 * width] = bytes(2 * width)

    walk(0, len(data))
    return bytes(out)


def dataset_frame(form: str, gray: np.ndarray) -> bytes:
    """One of phase 21's labelled frames (gray, its background flattened to
    80 so that six lossless files stay small) as a lossless AVIF: ``bgr``
    (identity 4:4:4), ``mono``, ``10bit`` (4:4:4), ``12bit`` (mono), ``irot``
    (bgr, an essential irot of 90°, which OpenCV does not apply) or
    ``extents`` (bgr, the payload in three iloc extents)."""
    import cv2

    bgr = np.repeat(gray[..., None], 3, axis=2)
    if form in ("bgr", "mono"):
        return cv2_file(bgr if form == "bgr" else gray)
    if form in ("10bit", "12bit"):
        depth = int(form[:2])
        v = (gray.astype(np.uint32) * ((1 << depth) - 1) // 255).astype(np.uint16)
        return cv2_file(np.repeat(v[..., None], 3, axis=2) if depth == 10 else v, cv2.IMWRITE_AVIF_DEPTH, depth)
    payload, av1c, colr = cv2_payload(bgr)
    h, w = gray.shape
    if form == "irot":
        return avif([image_item(payload, av1c, w, h, 8, 3, colr, extra=[(box(b"irot", b"\x01"), True)])])
    assert form == "extents", form
    n = len(payload)
    return avif([image_item(payload, av1c, w, h, 8, 3, colr, extents=[n // 5, n // 2, n - n // 5 - n // 2])],
                iloc_version=1)


def cases() -> dict:
    """{name: file bytes} of every form the fixtures cover."""
    import cv2

    out = {}
    # cv2's lossless files at odd sizes (across the 4x4 and 64x64 edges), BGR and gray, 8, 10 and 12 bits
    for w, h in ((1, 1), (7, 5), (65, 129), (257, 191)):
        seed = h * 1000 + w
        out[f"bgr-{w}x{h}"] = cv2_file(texture(h, w, seed))
        out[f"gray-{w}x{h}"] = cv2_file(texture(h, w, seed + 1, channels=1))
    for depth in (10, 12):
        for w, h in ((7, 5), (65, 129)):
            seed = depth * 100 + h
            out[f"bgr{depth}-{w}x{h}"] = cv2_file(texture(h, w, seed, depth=depth), cv2.IMWRITE_AVIF_DEPTH, depth)
            out[f"gray{depth}-{w}x{h}"] = cv2_file(texture(h, w, seed + 1, 1, depth), cv2.IMWRITE_AVIF_DEPTH, depth)
    out["bgra-33x17"] = cv2_file(np.dstack([texture(17, 33, 3), texture(17, 33, 4, channels=1)]))
    # the container forms, around cv2's payload of one image
    img = texture(23, 37, 9)
    payload, av1c, colr = cv2_payload(img)
    alpha_payload, alpha_av1c, _ = cv2_payload(texture(23, 37, 10, channels=1))

    def item(**kw):
        return image_item(payload, av1c, 37, 23, 8, 3, colr, **kw)

    auxc = full(b"auxC", 0, 0, b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")
    alpha = dict(id=2, type=b"av01", data=alpha_payload,
                 props=[(ispe(37, 23), False), (pixi(8, 1), False), (box(b"av1C", alpha_av1c), True), (auxc, False)])
    n = len(payload)
    forms = {
        "plain": dict(items=[item()]),
        "iloc1-idat": dict(items=[item(method=1)], iloc_version=1),
        "iloc2-sizes8": dict(items=[item()], iloc_version=2, sizes=(8, 8, 0, 0)),
        "iloc-base-offset": dict(items=[item(base=7)], sizes=(4, 4, 4, 0)),
        "iloc1-base8-index": dict(items=[item(base=7)], iloc_version=1, sizes=(8, 4, 8, 4)),
        "iloc-offset0": dict(items=[item()], sizes=(0, 4, 4, 0)),
        "extents": dict(items=[item(extents=[9, n // 2, n - 9 - n // 2])]),
        "extents-idat": dict(items=[item(method=1, extents=[n // 3, n - n // 3])], iloc_version=1),
        "irot": dict(items=[item(extra=[(box(b"irot", b"\x03"), True)])]),
        "imir": dict(items=[item(extra=[(box(b"imir", b"\x01"), True)])]),
        "clap": dict(items=[item(extra=[(box(b"clap", struct.pack(">8I", 21, 1, 11, 1, 0, 1, 0, 1)), True)])]),
        "irot-not-essential": dict(items=[item(extra=[(box(b"irot", b"\x01"), False)])]),
        "alpha": dict(items=[item(), alpha], refs=[(b"auxl", 2, [1])]),
        "alpha-no-auxc": dict(items=[item(), dict(alpha, props=alpha["props"][:3])], refs=[(b"auxl", 2, [1])]),
        "unknown-property": dict(items=[item(extra=[(box(b"zzzz", b"abc"), False)])]),
        "unknown-essential-property": dict(items=[item(extra=[(box(b"zzzz", b"abc"), True)])]),
        "infe3": dict(items=[item()], infe_version=3, iinf_version=1),
        "infe1": dict(items=[item()], infe_version=1),
        "ipma1-large-indices": dict(items=[item()], ipma_version=1, ipma_flags=1),
        "pitm1": dict(items=[item()], pitm_version=1),
        "no-pixi": dict(items=[dict(item(), props=item()["props"][:1] + item()["props"][2:])]),
        "no-ispe": dict(items=[dict(item(), props=item()["props"][1:])]),
        "no-colr": dict(items=[image_item(payload, av1c, 37, 23, 8, 3, None)]),
        "limited-range": dict(items=[image_item(payload, av1c, 37, 23, 8, 3, colr_nclx(2, 2, 0, 0))]),
        "pixi-depth-10": dict(items=[image_item(payload, av1c, 37, 23, 10, 3, colr)]),
        "mif1-brand-only": dict(items=[item()], major=b"mif1", brands=(b"mif1", b"miaf")),
        "avif-compatible-brand": dict(items=[item()], major=b"mif1", brands=(b"mif1", b"avif")),
        "handler-vide": dict(items=[item()], hdlr=b"vide"),
        # refused by name: what OpenCV reads and the port does not decode
        "bt709-matrix": dict(items=[image_item(payload, av1c, 37, 23, 8, 3, colr_nclx(1, 1, 1, 1))]),
        "premultiplied-alpha": dict(items=[item(), alpha], refs=[(b"auxl", 2, [1]), (b"prem", 1, [2])]),
        "ispe-scaled": dict(items=[image_item(payload, av1c, 40, 23, 8, 3, colr)]),
        "screen-content": dict(items=[image_item(rewrite(payload, "screen"), av1c, 37, 23, 8, 3, colr)]),
        "film-grain": dict(items=[image_item(rewrite(payload, "grain"), av1c, 37, 23, 8, 3, colr)]),
    }
    for name, kw in forms.items():
        out[f"box-{name}"] = avif(kw.pop("items"), **kw)
    # tools/av1_writer.py's lossless streams: the bitstream forms cv2 does not write
    aw = _tool("av1_writer")
    every = {b: [1.0] * 10 for b in (3, 6, 9, 12, 15)}  # every partition type at every square size
    small = {12: [0, 0, 0, 1] + [0] * 6, 9: [0, 0, 0, 1] + [0] * 6, 6: [1, 1, 1, 4] + [1] * 6, 3: [1, 1, 1, 6]}
    for name, (shape, depth, kw) in {
        "full-header": ((70, 90, 1), 8, dict(reduced=False)),
        "frame-header-and-tile-groups": ((96, 140, 1), 8, dict(reduced=False, split_obus=True, tile_groups=2,
                                                                 tiles=("uniform", 1, 0))),
        "tiles-uniform-2x2": ((150, 140, 1), 8, dict(tiles=("uniform", 1, 1))),
        "tiles-sizes": ((70, 200, 1), 8, dict(tiles=("sizes", [1, 3], [2]))),
        "sb128": ((140, 150, 1), 8, dict(sb128=True, seed=3)),
        "sb128-none": ((136, 144, 1), 8, dict(sb128=True, weights={15: [1, 0, 0, 0, 0, 0, 0, 0]})),
        "sb128-partitions": ((200, 136, 1), 8, dict(sb128=True, weights=every, seed=5)),
        "partitions": ((100, 90, 3), 8, dict(weights=every, seed=6)),
        "no-cdf-update": ((70, 90, 1), 8, dict(disable_cdf_update=1)),
        "10bit-444": ((40, 50, 3), 10, dict(tiles=("uniform", 0, 0))),
        "12bit-mono-full-header": ((40, 50, 1), 12, dict(reduced=False)),
        "metadata-padding": ((33, 20, 1), 8, dict(extra_obus=[(5, bytes([4, 0, 0, 0, 0x80])), (15, bytes([1, 2, 0x80]))])),
        # every intra mode down to 4x4 blocks (CFL): the tools libaom's lossless encoder leaves unused
        "intra-modes": ((64, 72, 3), 8, dict(weights=small, seed=7)),
        "intra-modes-10bit": ((40, 48, 3), 10, dict(weights=small, seed=8)),
        "intra-modes-12bit-mono": ((56, 40, 1), 12, dict(weights=small, seed=9)),
    }.items():
        h, w, channels = shape
        planes = [texture(h, w, 50 + k, channels=1, depth=depth).astype(np.uint16) for k in range(channels)]
        payload = aw.encode(planes, depth, **kw)
        mono = channels == 1
        out[f"av1-{name}"] = avif([image_item(payload, aw.av1c(depth, mono), w, h, depth, channels,
                                              None if mono else colr_nclx(1, 13, 0, 1))])
    # meta after a 500-byte mdat: past OpenCV's signature bytes
    big_payload, big_av1c, big_colr = cv2_payload(texture(40, 40, 11))
    out["box-mdat-first-past-signature"] = avif([image_item(big_payload, big_av1c, 40, 40, 8, 3, big_colr)],
                                                mdat_first=True)
    small_payload, small_av1c, small_colr = cv2_payload(texture(3, 4, 12))
    out["box-mdat-first"] = avif([image_item(small_payload, small_av1c, 4, 3, 8, 3, small_colr)], mdat_first=True)
    out["refused-lossy-420"] = cv2_file(img, cv2.IMWRITE_AVIF_QUALITY, 75)  # libaom applies CDEF at 75
    anim = cv2.Animation()
    anim.frames = [texture(64, 64, 13), texture(64, 64, 14)]
    anim.durations = [100, 100]
    ok, buf = cv2.imencodeanimation(".avif", anim)
    assert ok
    out["refused-sequence"] = _without_times(buf.tobytes())
    tiles = [cv2_payload(texture(64, 64, 15 + k)) for k in range(2)]
    grid = dict(id=1, type=b"grid", data=bytes([0, 0, 0, 1, 0, 128, 0, 64]), method=1,
                props=[(ispe(128, 64), False), (pixi(8, 3), False), (box(b"colr", tiles[0][2]), False)])
    parts = [dict(id=2 + k, type=b"av01", data=p, props=[(ispe(64, 64), False), (pixi(8, 3), False),
                                                          (box(b"av1C", a), True), (box(b"colr", c), False)])
             for k, (p, a, c) in enumerate(tiles)]
    out["refused-grid"] = avif([grid] + parts, iloc_version=1, refs=[(b"dimg", 1, [2, 3])])
    # cut and damaged copies of a few forms, against cv2
    for base in ("bgr-7x5", "gray-7x5", "bgr10-7x5", "bgra-33x17", "box-extents-idat"):
        data = out[base]
        for frac in (30, 60, 90, 99):
            out[f"cut-{base}-{frac}"] = data[: len(data) * frac // 100]
        rng = np.random.default_rng(len(data))
        for j in range(6):
            b = bytearray(data)
            k = int(rng.integers(16, len(data)))
            b[k] ^= int(rng.integers(1, 256))
            out[f"damaged-{base}-{j}"] = bytes(b)
    # chip_smoke.py phase 21: the 2048² micrograph and the labelled frames, held by the SHA-256 of cv2's array
    out["smoke-gray-2048"] = cv2_file(particles(2048, 0))
    smoke = _tool("make_torch_container_fixtures")._chip_smoke()
    rng = np.random.default_rng(smoke.AVIF_SEED)
    for form in smoke.AVIF_FORMS:
        gray, _ = smoke.draw_labelled(rng, smoke.DATASET_HW)
        out[f"dataset-{form}"] = dataset_frame(form, smoke.avif_flatten(gray))
    return out


# the entries held by the SHA-256 of cv2's array rather than the array: phase 21's, and arrays of more
# than 64x64 pixels
HASHED_PREFIXES = ("smoke-", "dataset-")
HASHED_PIXELS = 64 * 64


def _reference(path: str):
    import cv2

    try:
        return cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:  # an image past OpenCV's size limits raises; the JAX package reads None
        return None


def main(out: str = str(DEFAULT_OUT)) -> str:
    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in cases().items():
            Path(path).write_bytes(data)
            ref = _reference(path)
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            if name in NAMED:
                arrays[f"{name}/named"] = np.frombuffer(NAMED[name].encode(), np.uint8)
            if name in CDEF:
                arrays[f"{name}/cdef"] = np.zeros(0, np.uint8)
            if name in SEGMENTATION:
                arrays[f"{name}/segmentation"] = np.zeros(0, np.uint8)
            if ref is None:
                arrays[f"{name}/none"] = np.zeros(0, np.uint8)
            elif name.startswith(HASHED_PREFIXES) or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
        # C12: cv2's outcome on each damaged or cut C11 TIFF, the SHA-256 of its array (zeros for None)
        c11 = np.load(Path(__file__).resolve().parents[1] / "tests" / "data" / "torch_jpeg2000_fixtures.npz")
        tif = str(Path(d) / "f.tif")
        hashes = np.zeros((800, 64), np.uint8)
        for i, (_, data) in enumerate(c12_copies(c11)):
            Path(tif).write_bytes(data)
            ref = _reference(tif)
            if ref is not None:
                hashes[i] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
        arrays["c12/sha256"] = hashes
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())
