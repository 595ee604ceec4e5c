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

import random
import threading
import time

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
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="frame_0.jpg"):
        imageio.load_image(str(tmp_path / "frame_0.jpg"))


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
