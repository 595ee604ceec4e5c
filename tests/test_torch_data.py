"""The port's host loaders vs gmf_tpu's: the PNG decoder and the resize
(against matplotlib and cv2 through gmf_tpu's imageio), the 3DMatch,
3DLoMatch and KITTI datasets on fixture trees (tests/torch_eval_fixtures.py)
with ``random`` and ``np.random`` seeded alike, and the prefetch thread.

Sample arrays are equal, but for two kinds held to 1e-6:
- points that went through a rigid transform in f32 (the augmented
  targets, and what is built from them): gmf_tpu runs that transform
  through XLA, the port through PyTorch, and the two sum the 3-term
  products apart, within 1 ulp at these coordinates; the labels and
  matched indices built from them stay equal;
- frames resized on the way (the fixtures' 48 x 64 PNGs to 120 x 160):
  the port's bilinear resize lies within 1e-6 of cv2's on float input;
  KITTI's uint8 frames within 1 code (cv2 rounds its fixed-point sums
  in SIMD lanes apart from its scalar tail).
"""

import io
import random
import shutil
import threading
import time
from pathlib import Path

import matplotlib.image as mpimg
import numpy as np
import pytest
from PIL import Image

import torch_eval_fixtures as fx
from gmf_tpu.data import imageio as jax_imageio
from gmf_tpu.data.kitti import KITTIDataset as JaxKITTI
from gmf_tpu.data.threedmatch import SCENE_LIST as JAX_SCENES
from gmf_tpu.data.threedmatch import ThreeDLoMatchTest as JaxLoMatch
from gmf_tpu.data.threedmatch import ThreeDMatchTest as JaxTest
from gmf_tpu.data.threedmatch import ThreeDMatchTrainVal as JaxTrainVal
from gmf_tpu.data.threedmatch import load_gt_log as jax_load_gt_log
from gmf_tpu_torch.data import imageio
from gmf_tpu_torch.data.kitti import KITTIDataset
from gmf_tpu_torch.data.prefetch import prefetch_iter
from gmf_tpu_torch.data.threedmatch import (SCENE_LIST, ThreeDLoMatchTest,
                                            ThreeDMatchTest,
                                            ThreeDMatchTrainVal, load_gt_log)
from gmf_tpu_torch.utils.lru import host_io_cache

# what passed through the f32 rigid transform or the resize (module
# docstring)
WITHIN_1E6 = ("tgt_keypts", "corr_pos", "p_image", "q_image")


def _smooth(rng, h, w, c):
    """A smooth image with noise, so an encoder picks every PNG filter."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + k) * np.cos(yy / 7.0)
                     for k in range(c)], -1) * 0.45 + 0.5
    return np.clip(base + 0.05 * rng.rand(h, w, c), 0, 1)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray_alpha8",
                                  "gray16", "rgb16"])
def test_png_matches_matplotlib(tmp_path, kind):
    rng = np.random.RandomState(0)
    img = _smooth(rng, 37, 53, 4)
    if kind == "gray16":
        pil = Image.fromarray((img[..., 0] * 65535).astype(np.uint16))
    elif kind == "rgb16":  # Pillow writes no 16-bit colour: by hand
        pil = None
        _write_png16(tmp_path / "x.png", (img[..., :3] * 65535).astype(
            np.uint16))
    else:
        ch = {"rgb8": 3, "rgba8": 4, "gray8": 1, "gray_alpha8": 2}[kind]
        a = (img[..., :ch] * 255).astype(np.uint8)
        pil = Image.fromarray(a[..., 0] if ch == 1 else a,
                              mode={1: "L", 2: "LA", 3: "RGB",
                                    4: "RGBA"}[ch])
    if pil is not None:
        pil.save(tmp_path / "x.png")
    ref = mpimg.imread(tmp_path / "x.png")
    got = imageio.read_png(str(tmp_path / "x.png"))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def _write_png16(path, rgb):
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].astype(">u2").tobytes()
                   for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode,hw,aim", [
    ("resize", (48, 64), (120, 160)),    # up, by 2.5
    ("resize", (480, 640), (120, 160)),  # down, by 4
    ("resize", (97, 131), (40, 53)),     # down, ragged
    ("clip/center", (50, 70), (120, 160)),  # doubles, then crops
    ("clip/normal", (300, 400), (120, 160)),  # halves, then crops
    ("clip/random", (130, 170), (120, 160)),
    ("padding", (100, 200), (120, 160)),
])
def test_process_image_matches_jax(mode, hw, aim, dtype):
    """Float within 1e-6 of cv2's INTER_LINEAR, uint8 within 1 code."""
    rng = np.random.RandomState(1)
    img = rng.rand(*hw, 3)
    img = (img * 255).astype(np.uint8) if dtype == "uint8" \
        else img.astype(np.float32)
    mode, _, clip_mode = mode.partition("/")
    kw = dict(mode=mode, clip_mode=clip_mode or "center")
    np.random.seed(5)
    ref = jax_imageio.process_image(img, *aim, **kw)
    np.random.seed(5)
    got = imageio.process_image(img, *aim, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1.0 if dtype == "uint8" else 1e-6)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_load_image_matches_jax(tmp_path, ext):
    rng = np.random.RandomState(2)
    path = str(tmp_path / f"frame_0.{ext}")
    Image.fromarray((_smooth(rng, 60, 80, 3) * 255).astype(np.uint8)).save(
        path)
    np.testing.assert_allclose(imageio.load_image(path),
                               jax_imageio.load_image(path), rtol=0,
                               atol=1e-6)


def test_jpeg_without_pillow_names_the_file(tmp_path, monkeypatch):
    """With Pillow unimportable a JPEG frame still loads (the port decodes
    it itself, as Pillow does), and a file the decoder refuses raises
    naming the file."""
    import builtins

    rng = np.random.RandomState(3)
    good = str(tmp_path / "frame_0.jpg")
    Image.fromarray((_smooth(rng, 30, 44, 3) * 255).astype(np.uint8)).save(
        good)
    ref = jax_imageio.load_image(good)
    bad = str(tmp_path / "frame_1.jpg")
    Image.fromarray((_smooth(rng, 30, 44, 3) * 255).astype(np.uint8)).save(
        bad, progressive=True)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    # the resize to 120 x 160 within 1e-6 of cv2's (module docstring)
    np.testing.assert_allclose(imageio.load_image(good), ref, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="frame_1.jpg.*progressive"):
        imageio.load_image(bad)


# -- the JPEG decoder against Pillow ---------------------------------------

JPEG_FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "jpeg"


def _jpeg_frame(rng, h, w, gray):
    img = (_smooth(rng, h, w, 3) * 255 + rng.randint(-30, 31, (h, w, 3)))
    im = Image.fromarray(img.clip(0, 255).astype(np.uint8))
    return im.convert("L") if gray else im


# (height, width, gray, Pillow save arguments): every subsampling at low,
# middle and top quality, gray, optimised Huffman tables, restart
# intervals of one MCU and more, sizes off the MCU grid down to one pixel
JPEG_CASES = {
    "420_q10": (48, 64, False, dict(quality=10, subsampling=2)),
    "420_q75": (48, 64, False, dict(quality=75, subsampling=2)),
    "420_q100": (48, 64, False, dict(quality=100, subsampling=2)),
    "422_q50": (48, 64, False, dict(quality=50, subsampling=1)),
    "422_q95": (37, 53, False, dict(quality=95, subsampling=1)),
    "444_q30": (48, 64, False, dict(quality=30, subsampling=0)),
    "444_q100": (29, 31, False, dict(quality=100, subsampling=0)),
    "gray_q60": (48, 64, True, dict(quality=60)),
    "gray_odd_rst": (33, 70, True, dict(quality=85,
                                        restart_marker_blocks=1)),
    "420_optimized": (48, 64, False, dict(quality=70, subsampling=2,
                                          optimize=True)),
    "420_rst1": (40, 56, False, dict(quality=80, subsampling=2,
                                     restart_marker_blocks=1)),
    "422_rst3_optimized": (40, 56, False, dict(
        quality=80, subsampling=1, restart_marker_blocks=3, optimize=True)),
    "420_161x121": (121, 161, False, dict(quality=85, subsampling=2)),
    "420_17x9": (9, 17, False, dict(quality=90, subsampling=2)),
    "420_2x3": (3, 2, False, dict(quality=90, subsampling=2)),
    "422_5x2": (2, 5, False, dict(quality=90, subsampling=1)),
    "444_1x1": (1, 1, False, dict(quality=90, subsampling=0)),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_matches_pillow(tmp_path, case):
    """Every bit of the decode equals Pillow's (libjpeg-turbo's)."""
    h, w, gray, kw = JPEG_CASES[case]
    path = str(tmp_path / f"{case}.jpg")
    _jpeg_frame(np.random.RandomState(len(case)), h, w, gray).save(
        path, "JPEG", **kw)
    ref = np.asarray(Image.open(path))
    got = imageio.read_jpeg(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, mpimg.imread(path))


@pytest.mark.parametrize("name", sorted(
    p.stem for p in JPEG_FIXTURES.glob("*.npy")) + ["frame_640x480"])
def test_jpeg_fixtures_still_match_pillow(name):
    """The committed fixtures that chip_smoke.py decodes on the card: each
    array (the 640 x 480 frame's SHA-256) is still Pillow's decode of its
    file, and the port's too."""
    import hashlib
    import json

    path = JPEG_FIXTURES / f"{name}.jpg"
    pil, got = np.asarray(Image.open(path)), imageio.read_jpeg(str(path))
    if name == "frame_640x480":
        want = json.loads((JPEG_FIXTURES / f"{name}.json").read_text())
        for a in (pil, got):
            assert list(a.shape) == want["shape"]
            assert hashlib.sha256(a.tobytes()).hexdigest() == want["sha256"]
        return
    arr = np.load(JPEG_FIXTURES / f"{name}.npy")
    np.testing.assert_array_equal(pil, arr)
    np.testing.assert_array_equal(got, arr)


def _patched(blob: bytes, marker: int, offset: int, value: int) -> bytes:
    """blob with the byte ``offset`` past the first ``marker`` set."""
    i = blob.index(bytes([0xFF, marker]))
    out = bytearray(blob)
    out[i + offset] = value
    return bytes(out)


def _refused(kind):
    rng = np.random.RandomState(4)
    buf = io.BytesIO()
    im = _jpeg_frame(rng, 24, 32, False)
    if kind == "progressive":
        im.save(buf, "JPEG", progressive=True)
        return buf.getvalue(), "progressive"
    if kind == "cmyk":
        im.convert("CMYK").save(buf, "JPEG")
        return buf.getvalue(), "CMYK"
    if kind == "adobe_rgb":
        im.save(buf, "JPEG", keep_rgb=True)
        return buf.getvalue(), "Adobe transform 0"
    im.save(buf, "JPEG")
    blob = buf.getvalue()
    if kind == "arithmetic":  # SOF0 -> SOF9
        return _patched(blob, 0xC0, 1, 0xC9), "arithmetic"
    if kind == "12bit":       # SOF0's precision byte
        return _patched(blob, 0xC0, 4, 12), "12-bit"
    if kind == "truncated":  # cut in the headers, and in the scan
        return blob[:len(blob) // 4], "truncated"
    if kind == "truncated_scan":
        return blob[:len(blob) - 40], "truncated"
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "adobe_rgb",
                                  "arithmetic", "12bit", "truncated",
                                  "truncated_scan"])
def test_jpeg_refusals_name_the_feature(kind):
    blob, what = _refused(kind)
    with pytest.raises(ValueError, match=f"frame.jpg: .*{what}"):
        imageio.decode_jpeg(blob, "frame.jpg")
    with pytest.raises(ValueError, match="progressive"):
        imageio.read_jpeg(str(JPEG_FIXTURES / "progressive.jpg"))


# -- datasets ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("threedmatch"))
    return fx.write_3dmatch_tree(root)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    return fx.write_kitti_tree(root, splits=("train", "test"))


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _assert_samples_equal(got, ref, image_atol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], str):
            assert got[k] == ref[k], k
            continue
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in WITHIN_1E6:
            atol = image_atol if k.endswith("_image") else 1e-6
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _compare(make_port, make_jax, seeds=(0, 1), image_atol=1e-6):
    """Every sample of both datasets, each drawn after the same seeds; the
    host IO cache is emptied first so both packages decode the files."""
    host_io_cache().reset()
    port, ref = make_port(), make_jax()
    assert len(port) == len(ref) > 0
    for s in seeds:
        for i in range(len(ref)):
            _seed(s)
            r = ref[i]
            _seed(s)
            _assert_samples_equal(port[i], r, image_atol)


def test_scene_list_and_gt_log(tree):
    assert SCENE_LIST == JAX_SCENES
    got = load_gt_log(f"{tree['root']}/{tree['scene']}")
    ref = jax_load_gt_log(f"{tree['root']}/{tree['scene']}")
    assert list(got) == list(ref) == ["0_1", "0_2", "1_2"]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("kw", [
    dict(), dict(num_node=100), dict(use_mutual=False, in_dim=9),
    dict(device_match=True), dict(device_match=True, num_node=90)],
    ids=["all", "num_node", "no_mutual_in9", "device_match",
         "device_match_sub"])
def test_threedmatch_test_matches_jax(tree, kw):
    args = dict(root=tree["root"], select_scene=tree["scene"], **kw)
    _compare(lambda: ThreeDMatchTest(**args), lambda: JaxTest(**args))


@pytest.fixture(scope="module")
def jpeg_tree(tree, tmp_path_factory):
    """The fixture tree with every frame a JPEG (3DMatch's ``*_0.jpg``):
    fragment 2's gray, the others 4:2:0 colour."""
    root = str(tmp_path_factory.mktemp("threedmatch_jpeg") / "root")
    shutil.copytree(tree["root"], root)
    for png in sorted(Path(root).rglob("*_0.png")):
        gray = png.name.startswith("cloud_bin_2")
        Image.open(png).convert("L" if gray else "RGB").save(
            png.with_suffix(".jpg"), "JPEG", quality=85)
        png.unlink()
    return {**tree, "root": root}


def test_threedmatch_jpeg_frames_match_jax(jpeg_tree):
    """3DMatch's real frames are JPEG: the datasets read them as gmf_tpu's
    do through mpimg (Pillow), the resize within 1e-6 (module
    docstring)."""
    args = dict(root=jpeg_tree["root"], select_scene=jpeg_tree["scene"])
    assert not list(Path(args["root"]).rglob("*_0.png"))
    _compare(lambda: ThreeDMatchTest(**args), lambda: JaxTest(**args),
             seeds=(0,))


@pytest.mark.parametrize("kw", [dict(num_node="all"), dict(num_node=120),
                                dict(num_node="all", device_match=True),
                                dict(num_node=120, device_match=True)],
                         ids=["all", "num_node", "device_match",
                              "device_match_sub"])
def test_threedlomatch_matches_jax(tree, kw):
    args = dict(root=tree["root"], pair_file=tree["pair_file"], **kw)
    _compare(lambda: ThreeDLoMatchTest(**args), lambda: JaxLoMatch(**args))


@pytest.mark.parametrize("kw", [dict(), dict(num_node="all"),
                                dict(augment_axis=1, in_dim=3)],
                         ids=["num_node", "all", "one_axis_in3"])
def test_threedmatch_trainval_matches_jax(tree, kw):
    args = dict(root=tree["root"], split="train",
                overlap_path=tree["overlap_path"],
                split_file=tree["split_file"], num_node=kw.pop("num_node",
                                                               100), **kw)
    _compare(lambda: ThreeDMatchTrainVal(**args),
             lambda: JaxTrainVal(**args), seeds=(0, 1, 2))


@pytest.mark.parametrize("kw", [dict(split="train", num_node=150),
                                dict(split="test", num_node="all"),
                                dict(split="train", num_node=150,
                                     device_match=True)],
                         ids=["train", "test", "device_match"])
def test_kitti_matches_jax(kitti, kw):
    args = dict(root=kitti, **kw)
    _compare(lambda: KITTIDataset(**args), lambda: JaxKITTI(**args),
             image_atol=1.0)


# -- prefetch (as tests/test_prefetch.py) -----------------------------------

def test_prefetch_order_and_passthrough():
    items = list(range(100))
    assert list(prefetch_iter(iter(items), depth=3)) == items
    assert list(prefetch_iter(iter(items), depth=0)) == items


def test_prefetch_propagates_exceptions():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    out = []
    with pytest.raises(ValueError, match="boom"):
        for x in prefetch_iter(gen(), depth=2):
            out.append(x)
    assert out == [1, 2]


def test_prefetch_abandonment_retires_producer():
    started = threading.active_count()
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch_iter(gen(), depth=2)
    for x in it:
        if x >= 3:
            break  # abandon mid-stream with the queue full
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= started
    assert len(produced) < 100
