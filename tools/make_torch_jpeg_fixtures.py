"""Write the JPEG fixtures of the PyTorch port's decoder.

The port decodes JPEG without OpenCV (``deepemia_tpu_torch/native/codecs.cpp:
jpeg_decode``), to the pixels ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns.
A machine without OpenCV (the GPU host that runs ``chip_smoke.py``) checks
that against this file: small JPEGs written here by OpenCV and PIL (gray;
4:2:0; 4:2:2 with restart markers; progressive; 4:4:4 with optimised
Huffman tables and a restart marker after every MCU; PIL's 4:2:0 with EXIF
Orientation 6), each beside the array ``cv2.imread`` returns for it.

Needs OpenCV and PIL.

    python tools/make_torch_jpeg_fixtures.py   # writes tests/data/torch_jpeg_fixtures.npz

The file holds, for each case, ``<case>.jpg`` (the file's bytes, uint8)
and ``<case>`` ([H,W,3] uint8 BGR).
"""

from __future__ import annotations

import io
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_jpeg_fixtures.npz")


def _micrograph(h: int, w: int, seed: int) -> np.ndarray:
    """Grey noise, blurred, with bright and dark particles: BGR uint8."""
    import cv2

    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur((rng.normal(120, 40, (h, w))).clip(0, 255).astype(np.uint8), (5, 5), 1.5)
    for _ in range(12):
        cv2.circle(img, (int(rng.integers(0, w)), int(rng.integers(0, h))), int(rng.integers(3, 12)),
                   int(rng.choice([20, 235])), -1)
    bgr = np.stack([img, img, img], -1)
    bgr[: h // 6, : w // 3] = (200, 90, 30)  # a coloured label strip: chroma to subsample
    return bgr


def cases():
    """-> {case: JPEG bytes}."""
    import cv2
    from PIL import Image

    def enc(img, params):
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        return buf.tobytes()

    img = _micrograph(72, 88, 0)
    out = {
        "gray": enc(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), [cv2.IMWRITE_JPEG_QUALITY, 90]),
        "s420": enc(img, [cv2.IMWRITE_JPEG_QUALITY, 75,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
        "s422_restart": enc(_micrograph(45, 61, 1), [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
        "progressive": enc(_micrograph(57, 70, 2), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
        "s444_optimize_restart": enc(_micrograph(40, 52, 3), [cv2.IMWRITE_JPEG_QUALITY, 95,
                                                              cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                              cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
    }
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(_micrograph(24, 40, 4)[..., ::-1]).save(buf, "JPEG", quality=90, exif=exif.tobytes())
    out["exif6"] = buf.getvalue()
    return out


def main(path: str = DEFAULT_OUT) -> None:
    import tempfile

    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in cases().items():
            f = os.path.join(tmp, f"{name}.jpg")
            with open(f, "wb") as fh:
                fh.write(data)
            ref = cv2.imread(f, cv2.IMREAD_COLOR)
            assert ref is not None, name
            arrays[f"{name}.jpg"] = np.frombuffer(data, np.uint8)
            arrays[name] = ref
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, {len(arrays) // 2} cases)")


if __name__ == "__main__":
    main()
