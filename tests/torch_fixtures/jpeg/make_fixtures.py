"""Write the JPEG fixtures of this folder with Pillow, each beside its
Pillow-decoded array (``<name>.npy``, what ``mpimg.imread`` returns), and
a 640 x 480 frame (3DMatch's size) beside the SHA-256 of its decoded
array (``frame_640x480.json``), which chip_smoke.py times the decoder on.

    python tests/torch_fixtures/jpeg/make_fixtures.py

The card's machine has no Pillow, so ``chip_smoke.py`` reads these files
and arrays as they are committed; ``tests/test_torch_data.py`` checks
that they still equal Pillow's decode. ``progressive.jpg`` has no array:
the port's decoder must refuse it.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent

# name -> (height, width, mode, Pillow save arguments)
FIXTURES = {
    "rgb420_q75": (18, 26, "RGB", dict(quality=75, subsampling=2)),
    "rgb422_q90": (18, 26, "RGB", dict(quality=90, subsampling=1)),
    "rgb444_q95": (18, 26, "RGB", dict(quality=95, subsampling=0)),
    "gray_q80": (18, 26, "L", dict(quality=80)),
    "rgb420_optimized": (18, 26, "RGB", dict(quality=60, subsampling=2,
                                             optimize=True)),
    "rgb420_restart": (18, 26, "RGB", dict(quality=85, subsampling=2,
                                           restart_marker_blocks=2)),
    "rgb420_161x121": (121, 161, "RGB", dict(quality=85, subsampling=2)),
    "progressive": (18, 26, "RGB", dict(quality=75, progressive=True)),
}


def frame(h: int, w: int, mode: str, seed: int, period: float = 5.0,
          noise: int = 48) -> Image.Image:
    """A colour ramp with a wave and noise, so that chroma and edges
    matter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ramp = np.stack([255 * xx / max(w - 1, 1), 255 * yy / max(h - 1, 1),
                     127.5 + 127.5 * np.sin((xx + 2 * yy) / period)], -1)
    rgb = (ramp + rng.randint(-noise, noise + 1, ramp.shape)).clip(0, 255)
    im = Image.fromarray(rgb.astype(np.uint8))
    return im.convert("L") if mode == "L" else im


def main():
    for i, (name, (h, w, mode, kw)) in enumerate(sorted(FIXTURES.items())):
        path = HERE / f"{name}.jpg"
        frame(h, w, mode, seed=i).save(path, "JPEG", **kw)
        if name != "progressive":
            np.save(HERE / f"{name}.npy", np.asarray(Image.open(path)))
    # smooth and no noise, so that the file stays small (~10 KB)
    path = HERE / "frame_640x480.jpg"
    frame(480, 640, "RGB", seed=0, period=120.0, noise=0).save(
        path, "JPEG", quality=50)
    arr = np.asarray(Image.open(path))
    (HERE / "frame_640x480.json").write_text(json.dumps(
        {"shape": list(arr.shape),
         "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}) + "\n")


if __name__ == "__main__":
    main()
