"""Image loading and preprocessing, with no imaging package.

Counterpart of ``gmf_tpu/data/imageio.py``, which reads with
``matplotlib.image.imread`` (through Pillow) and resizes with
``cv2.resize`` (Pillow as its fallback). The port imports neither, and
the card's machine has neither, so all three are done here:

- ``read_png``: a PNG decoder on ``zlib`` and numpy (8- and 16-bit gray,
  gray+alpha, RGB and RGBA; filter types 0-4; not interlaced) returning
  what ``mpimg.imread`` returns for a PNG: float32 in [0, 1], [H, W] for
  gray and [H, W, 3 or 4] otherwise. As there (matplotlib reads through
  Pillow), gray+alpha comes back as RGBA and 16-bit colour as its high
  byte over 255; 16-bit gray is over 65535. With ``raw=True`` it returns
  the stored samples instead (uint8 or uint16, [H, W] for gray, [H, W,
  samples a pixel] otherwise): a 16-bit depth frame in its own units.
- ``resize_bilinear``: cv2's ``INTER_LINEAR``: half-pixel centres, edge
  samples clamped, no antialiasing. Float images as float32, uint8 images
  with cv2's 11-bit fixed-point weights, rounded, returned as float32 of
  the codes (0-255), which is what the reference's ``_resize`` returns
  for uint8 input.
- ``read_jpeg``: a baseline JPEG decoder in C++ (``cpp/jpeg/``, built
  by ``utils/native.py`` at first use into the git-ignored
  ``gmf_tpu_torch/ops/build/``, called through ctypes) returning what
  ``mpimg.imread`` returns for a JPEG, which is Pillow's
  ``np.asarray(Image.open(path))``: uint8 [H, W, 3], or [H, W] for gray,
  equal in every bit (libjpeg's ISLOW IDCT, fancy upsampling and
  YCbCr->RGB tables). 8-bit sequential Huffman frames (SOF0/SOF1), 1 or
  3 components, sampling factors up to 2 x 2, restart intervals, any
  size. Progressive, arithmetic, lossless, 12-bit, CMYK and untransformed
  RGB files raise ValueError naming the file and what it uses; a failed
  build raises RuntimeError.
- ``process_image`` (resize / clip / padding) and ``load_image`` (read,
  gray to RGB, alpha dropped, resize to (aim_H, aim_W)) as the
  reference's: ``.png`` through ``read_png``, anything else (``.jpg``,
  ``.jpeg``) through ``read_jpeg``.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from gmf_tpu_torch.utils.native import REPO, build_library

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _average_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for x in range(len(line)):
        left = cur[x - bpp] if x >= bpp else 0
        cur[x] = (line[x] + ((left + prev[x]) >> 1)) & 0xFF
    return cur


def _paeth_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for x in range(len(line)):
        if x >= bpp:
            a, c = cur[x - bpp], prev[x - bpp]
        else:
            a = c = 0
        b = prev[x]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (line[x] + pred) & 0xFF
    return cur


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: [h, row_bytes] uint8. Sub and Up are
    numpy passes; Average and Paeth depend on the byte just decoded, so
    they run a byte at a time."""
    if len(raw) != h * (row_bytes + 1):
        raise ValueError("PNG image data of the wrong size")
    data = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64),
                            axis=0).reshape(-1).astype(np.uint8)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average of left and up
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif ftype == 4:  # Paeth
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str, raw: bool = False) -> np.ndarray:
    """Decode the PNG at ``path`` as ``mpimg.imread`` does, or with
    ``raw`` as its stored samples (module docstring). Raises ValueError
    on a file it does not decode."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: PNG colour type {ctype}, bit depth {depth}, interlace "
            f"{interlace} not supported (8/16-bit gray, gray+alpha, RGB, "
            "RGBA, not interlaced)")
    ch = _PNG_CHANNELS[ctype]
    nbytes = depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * nbytes,
                     ch * nbytes).reshape(h, w, ch, nbytes)
    if raw:
        samples = (rows[..., 0].astype(np.uint16) << 8 | rows[..., 1]
                   if depth == 16 else rows[..., 0])
        return samples[..., 0] if ctype == 0 else samples
    if depth == 16 and ctype == 0:
        gray = rows[..., 0].astype(np.uint16) << 8 | rows[..., 1]
        return gray[..., 0].astype(np.float32) / np.float32(65535)
    img = rows[..., 0]  # 8-bit samples; the high byte of 16-bit colour
    if ctype == 0:
        return img[..., 0].astype(np.float32) / np.float32(255)
    if ctype == 4:  # gray+alpha -> RGBA
        img = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1)
    return img.astype(np.float32) / np.float32(255)


def _axis_weights(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: (left index, right index,
    weight of the right tap as float32)."""
    scale = src / dst
    f = (np.arange(dst) + 0.5) * scale - 0.5  # in double, as cv2
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    low = i0 < 0
    i0[low], f[low] = 0, 0.0
    high = i0 >= src - 1
    i0[high], f[high] = src - 1, 0.0
    return i0, np.minimum(i0 + 1, src - 1), f


def resize_bilinear(image: np.ndarray, aim_H: int, aim_W: int) -> np.ndarray:
    """[H, W, C] (or [H, W]) -> [aim_H, aim_W, ...] float32 (module
    docstring)."""
    image = np.asarray(image)
    H, W = image.shape[:2]
    y0, y1, fy = _axis_weights(H, aim_H)
    x0, x1, fx = _axis_weights(W, aim_W)
    extra = (None,) * (image.ndim - 2)
    if image.dtype == np.uint8:
        # 11-bit fixed-point weights, the rows pass then the columns
        ax1 = np.rint(fx * 2048).astype(np.int64)
        ay1 = np.rint(fy * 2048).astype(np.int64)
        ax0, ay0 = 2048 - ax1, 2048 - ay1
        img = image.astype(np.int64)
        rows = (img[:, x0] * ax0[(None, slice(None)) + extra]
                + img[:, x1] * ax1[(None, slice(None)) + extra])
        # the columns pass in cv2's vector form: each tap's product
        # shifted down apart, then one rounding
        out = (((rows[y0] >> 4) * ay0[(slice(None), None) + extra]) >> 16) \
            + (((rows[y1] >> 4) * ay1[(slice(None), None) + extra]) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.float32)
    img = image.astype(np.float32)
    wx1 = fx[(None, slice(None)) + extra]
    rows = img[:, x0] * (np.float32(1) - wx1) + img[:, x1] * wx1
    wy1 = fy[(slice(None), None) + extra]
    return (rows[y0] * (np.float32(1) - wy1)
            + rows[y1] * wy1).astype(np.float32)


def process_image(image, aim_H: int = 120, aim_W: int = 160,
                  mode: str = "resize", clip_mode: str = "center"):
    """Resize / clip / pad an [H, W, C] image to (aim_H, aim_W), as
    ``gmf_tpu/data/imageio.py::process_image`` (the reference's
    utils/uio.py:17-106)."""
    image = np.asarray(image)
    H, W, C = image.shape
    if H == aim_H and W == aim_W:
        return image

    if mode == "resize":
        return resize_bilinear(image, aim_H, aim_W)

    if mode == "clip":
        while H < aim_H or W < aim_W:
            image = resize_bilinear(image, H * 2, W * 2)
            H, W, C = image.shape
        if H > aim_H * 2 and W > aim_W * 2:
            image = resize_bilinear(image, H // 2, W // 2)
            H, W, C = image.shape
        if clip_mode == "center":
            top, left = (H - aim_H) // 2, (W - aim_W) // 2
        elif clip_mode == "normal":
            top, left = 0, 0
        elif clip_mode == "random":
            top = int(np.random.random() * (H - aim_H))
            left = int(np.random.random() * (W - aim_W))
        else:
            raise ValueError(clip_mode)
        return image[top: top + aim_H, left: left + aim_W]

    if mode == "padding":
        out = np.zeros((aim_H, aim_W, C), image.dtype)
        h, w = min(H, aim_H), min(W, aim_W)
        out[:h, :w] = image[:h, :w]
        return out

    raise ValueError(mode)


_JPEG_SOURCE = REPO / "cpp" / "jpeg" / "jpeg_decode.cpp"
_JPEG_LIB = None
_JPEG_LOCK = threading.Lock()


def _jpeg_lib():
    """The native decoder, built on first use."""
    global _JPEG_LIB
    with _JPEG_LOCK:
        if _JPEG_LIB is None:
            so = build_library(_JPEG_SOURCE, "libgmfjpeg",
                               "the native JPEG decoder")
            lib = ctypes.cdll.LoadLibrary(str(so))
            for fn in (lib.gmf_jpeg_info, lib.gmf_jpeg_decode):
                fn.restype = ctypes.c_int
            lib.gmf_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.gmf_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
            _JPEG_LIB = lib
        return _JPEG_LIB


def decode_jpeg(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """The JPEG file held in ``blob`` as ``read_jpeg`` returns it; a file
    it does not decode raises ValueError naming ``name``."""
    lib = _jpeg_lib()
    err = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int * 3)()
    if lib.gmf_jpeg_info(blob, len(blob), dims, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, c = dims
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    if lib.gmf_jpeg_decode(blob, len(blob), out.ctypes.data, out.nbytes,
                           err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG at ``path`` as ``mpimg.imread`` does (module
    docstring); raises ValueError naming the file on what it does not
    decode."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def to_frame(img: np.ndarray, aim_H: int = 120, aim_W: int = 160
             ) -> np.ndarray:
    """What ``load_image`` makes of a decoded image: uint8 codes over 255,
    gray to RGB, alpha dropped, resized to [aim_H, aim_W, 3] float32."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.shape[0] != aim_H or img.shape[1] != aim_W:
        img = process_image(img, aim_H, aim_W)
    return img.astype(np.float32)


def load_image(path: str, aim_H: int = 120, aim_W: int = 160) -> np.ndarray:
    """Read + resize, returning [aim_H, aim_W, 3] float32 in [0, 1]."""
    if path.lower().endswith(".png"):
        return to_frame(read_png(path), aim_H, aim_W)
    return to_frame(read_jpeg(path), aim_H, aim_W)
