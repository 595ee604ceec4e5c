"""flax's msgpack serialisation, read and written in plain Python and NumPy.

``gmf_tpu``'s checkpoints (``state.msgpack``, written by its
``utils/checkpoint.py::save_checkpoint``) are
``flax.serialization.msgpack_serialize`` of a tree of dicts, lists and
arrays. The card's machine has neither flax nor the ``msgpack`` package,
so this module decodes the bytes itself and returns what
``flax.serialization.msgpack_restore`` returns:

- the msgpack types such trees use: nil, bool, the integers (fixint,
  int/uint 8-64), float 32/64, str, bin, array, map and ext. Map keys are
  str or bytes, as ``msgpack.unpackb(..., raw=False)`` allows them; str
  is UTF-8, bin comes back as ``bytes``, an array as a list;
- flax's extension types: 1, an ndarray packed as ``(shape, dtype name,
  C-order bytes)``; 2, a native complex packed as ``(real, imag)``; 3, a
  NumPy scalar, packed as a 0-d ndarray. ``bfloat16``, which NumPy does
  not know, is read as its raw ``uint16`` bits and handed on as a
  ``torch.bfloat16`` tensor (a 0-d one for a scalar); every other array
  is a read-only NumPy array over the file's bytes, as flax's is;
- flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``, which it writes for an array over ``MAX_CHUNK_SIZE`` =
  2**30 bytes), put back together wherever flax's own restore does so:
  the tree itself, or a dict that is a value of a dict.

Anything else (a type byte msgpack does not define, an ext code flax does
not write, an ndarray payload that does not hold its shape, bytes left
after the object, a buffer that ends inside one) raises ``ValueError``
naming what was found and its byte offset; no partial tree is returned.

``msgpack_serialize`` writes the bytes ``flax.serialization.
msgpack_serialize`` writes (``msgpack.packb(..., strict_types=True)``
after ``jax.tree_util``'s copy of the tree), so that ``gmf_tpu`` reads
what the port writes:

- dict keys in sorted order, as ``jax.tree_util`` rebuilds a dict; None,
  bool, int, float (64-bit), str, bin (``bytes``, ``bytearray``,
  ``memoryview``) each in msgpack's smallest encoding, str and bin apart
  (``use_bin_type=True``); a list as an array. A tuple is an array too:
  flax's strict packer refuses tuples, so a tree holding one is written
  here and not by flax;
- a NumPy array or a torch tensor (copied to the host) as ext 1 of
  ``(shape, dtype name, C-order bytes)``, a ``torch.bfloat16`` tensor
  with the name ``bfloat16`` over its bits; a NumPy scalar as ext 3 (its
  0-d array), a Python complex as ext 2 (``(real, imag)``);
- an array over ``MAX_CHUNK_SIZE`` bytes that is the tree or a value of
  a dict reached through dicts only, as flax's chunked form.

Any other leaf (a subclass of these types among them, as the strict
packer refuses it) raises ``TypeError``, an int outside 64 bits
``ValueError``, each naming the leaf's path.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's: an array above it is written in chunks
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# type byte -> (struct format of the fixed-size value or length, its size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_STR = {0xd9: (">B", 1), 0xda: (">H", 2), 0xdb: (">I", 4)}
_BIN = {0xc4: (">B", 1), 0xc5: (">H", 2), 0xc6: (">I", 4)}
_EXT = {0xc7: (">B", 1), 0xc8: (">H", 2), 0xc9: (">I", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_ARRAY = {0xdc: (">H", 2), 0xdd: (">I", 4)}
_MAP = {0xde: (">H", 2), 0xdf: (">I", 4)}


class _Reader:
    """Decodes one msgpack object at a time from ``buf``; ``raw`` keeps
    str as bytes (``msgpack.unpackb(raw=True)``, flax's ndarray
    payloads)."""

    def __init__(self, buf, raw: bool = False, where: str = "state"):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.raw = raw
        self.where = where

    def _take(self, n: int, what: str) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(
                f"{self.where}: the buffer ends inside {what} at byte "
                f"{self.pos} (needs {n} bytes, {len(self.buf) - self.pos} "
                "left)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt_size, what: str):
        fmt, size = fmt_size
        return struct.unpack(fmt, self._take(size, what))[0]

    def _str(self, n: int, at: int):
        data = bytes(self._take(n, "a str"))
        if self.raw:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"{self.where}: the str at byte {at} is not "
                             f"UTF-8 ({e})") from None

    def read(self) -> Any:
        at = self.pos
        b = self._take(1, "a type byte")[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f, at)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f, at)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self._unpack(_FIXED[b], f"the number at byte {at}")
        if b in _STR:
            return self._str(self._unpack(_STR[b], "a str length"), at)
        if b in _BIN:
            return bytes(self._take(self._unpack(_BIN[b], "a bin length"),
                                    "a bin"))
        if b in _ARRAY:
            n = self._unpack(_ARRAY[b], "an array length")
            return [self.read() for _ in range(n)]
        if b in _MAP:
            return self._map(self._unpack(_MAP[b], "a map length"), at)
        if b in _FIXEXT or b in _EXT:
            n = (_FIXEXT[b] if b in _FIXEXT
                 else self._unpack(_EXT[b], "an ext length"))
            code = struct.unpack(">b", self._take(1, "an ext code"))[0]
            return self._ext(code, self._take(n, f"ext {code}'s data"), at)
        raise ValueError(f"{self.where}: type byte 0x{b:02x} at byte {at} "
                         "is not a msgpack type")

    def _map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.read()
            if not isinstance(key, (str, bytes)):
                raise ValueError(
                    f"{self.where}: the map at byte {at} has a key of type "
                    f"{type(key).__name__} at byte {key_at} (str or bytes "
                    "only)")
            out[key] = self.read()
        return out

    def _ext(self, code: int, data: memoryview, at: int):
        where = f"{self.where}, ext {code} at byte {at}"
        if code == EXT_NDARRAY:
            return _ndarray(data, where)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data, where)
            if arr.ndim:
                raise ValueError(f"{where}: a scalar of shape "
                                 f"{tuple(arr.shape)}")
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            parts = _whole(data, where, raw=False)
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(p, (int, float)) for p in parts)):
                raise ValueError(f"{where}: a complex is (real, imag), not "
                                 f"{parts!r}")
            return complex(parts[0], parts[1])
        raise ValueError(f"{self.where}: ext code {code} at byte {at} is "
                         "none of flax's (1 ndarray, 2 complex, 3 numpy "
                         "scalar)")


def _whole(data, where: str, raw: bool) -> Any:
    """The one object that fills ``data``."""
    r = _Reader(data, raw=raw, where=where)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{where}: {len(r.buf) - r.pos} bytes after the "
                         f"object, which ends at byte {r.pos}")
    return obj


def _ndarray(data, where: str):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, bytes)."""
    obj = _whole(data, where, raw=True)
    if not (isinstance(obj, list) and len(obj) == 3
            and isinstance(obj[0], list)
            and all(isinstance(d, int) and d >= 0 for d in obj[0])
            and isinstance(obj[1], bytes) and isinstance(obj[2], bytes)):
        raise ValueError(f"{where}: an ndarray is (shape, dtype name, "
                         "bytes), not this")
    shape, name, buf = tuple(obj[0]), obj[1].decode("ascii", "replace"), \
        obj[2]
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError:
        raise ValueError(f"{where}: unknown dtype {name!r}") from None
    if dtype.hasobject or dtype.fields:
        raise ValueError(f"{where}: dtype {name!r} is not a plain one")
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(buf) != want:
        raise ValueError(f"{where}: {len(buf)} bytes for a {name} array of "
                         f"shape {shape} ({want} bytes)")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    if bf16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def _unchunk(d: dict):
    """flax's ``_unchunk``: the chunks, concatenated, in their shape."""
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError):
        raise ValueError("a chunked array without its shape or chunks "
                         f"({sorted(d)})") from None
    if chunks and all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: a chunked array is put
    back together as the tree itself or as a dict's value, and the walk
    goes down dicts only."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_tree(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` of ``data`` (module
    docstring)."""
    return _unchunk_tree(_whole(data, "state", raw=False))


def read_msgpack(path: str) -> Any:
    """The tree in the file at ``path``; errors name the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return msgpack_restore(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# -- the writer ---------------------------------------------------------------

def _put_head(out: list, n: int, fix: int, fix_max: int, wide: tuple):
    """The header of a str, bin, array or map of ``n``: its fix form while
    ``n <= fix_max`` (``fix`` None: none), else the first of ``wide``'s
    (type byte, struct format, limit) that holds it."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for byte, fmt, limit in wide:
        if n <= limit:
            out.append(bytes([byte]) + struct.pack(fmt, n))
            return
    raise ValueError(f"{n} items or bytes: more than msgpack holds")


_B8, _B16, _B32 = 0xff, 0xffff, 0xffffffff
_STR_HEAD = ((0xd9, ">B", _B8), (0xda, ">H", _B16), (0xdb, ">I", _B32))
_BIN_HEAD = ((0xc4, ">B", _B8), (0xc5, ">H", _B16), (0xc6, ">I", _B32))
_ARRAY_HEAD = ((0xdc, ">H", _B16), (0xdd, ">I", _B32))
_MAP_HEAD = ((0xde, ">H", _B16), (0xdf, ">I", _B32))
_EXT_HEAD = ((0xc7, ">B", _B8), (0xc8, ">H", _B16), (0xc9, ">I", _B32))
_FIXEXT_HEAD = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
# (lowest, highest, type byte, struct format) in msgpack's order
_INTS = ((0, 0x7f, None, ">B"), (-0x20, -1, None, ">b"),
         (0x80, 0xff, 0xcc, ">B"), (-0x80, -1, 0xd0, ">b"),
         (0x100, 0xffff, 0xcd, ">H"), (-0x8000, -1, 0xd1, ">h"),
         (0x10000, 0xffffffff, 0xce, ">I"), (-0x80000000, -1, 0xd2, ">i"),
         (0x100000000, 2 ** 64 - 1, 0xcf, ">Q"), (-2 ** 63, -1, 0xd3, ">q"))


def _put_int(out: list, v: int, path: str):
    for lo, hi, byte, fmt in _INTS:
        if lo <= v <= hi:
            out.append((b"" if byte is None else bytes([byte]))
                       + struct.pack(fmt, v))
            return
    raise ValueError(f"{path}: the int {v} does not fit 64 bits")


def _put_str(out: list, v: str):
    data = v.encode("utf-8")
    _put_head(out, len(data), 0xa0, 31, _STR_HEAD)
    out.append(data)


def _put_bin(out: list, data):
    data = bytes(data)
    _put_head(out, len(data), None, 0, _BIN_HEAD)
    out.append(data)


def _host_array(x, path: str):
    """(a NumPy array of the leaf's bytes, its dtype name): a tensor
    copied to the host, bf16 as its uint16 bits; structured and object
    dtypes raise TypeError."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        try:
            x = t.numpy()
        except TypeError:
            raise TypeError(f"{path}: a tensor of {t.dtype}, which NumPy "
                            "does not hold") from None
    if x.dtype.hasobject or x.dtype.fields:
        raise TypeError(f"{path}: an array of dtype {x.dtype}, neither "
                        "plain nor supported by flax")
    return x, x.dtype.name


def _put_ext(out: list, code: int, payload: list):
    n = sum(len(p) for p in payload)
    if n in _FIXEXT_HEAD:
        out.append(bytes([_FIXEXT_HEAD[n]]))
    else:
        _put_head(out, n, None, 0, _EXT_HEAD)
    out.append(struct.pack(">b", code))
    out.extend(payload)


def _put_ndarray(out: list, arr, name: str, code: int = EXT_NDARRAY):
    """flax's ``_ndarray_to_bytes`` in an ext: ``packb((shape, dtype
    name, bytes), use_bin_type=True)``."""
    payload = []
    _put_head(payload, 3, 0x90, 15, _ARRAY_HEAD)
    _put_head(payload, arr.ndim, 0x90, 15, _ARRAY_HEAD)
    for d in arr.shape:
        _put_int(payload, int(d), "shape")
    _put_str(payload, name)
    _put_bin(payload, arr.tobytes("C"))
    _put_ext(out, code, payload)


def _put_chunked(out: list, arr, name: str):
    """flax's ``_chunk``: {CHUNKED: True, "shape": {"0": ...}, "chunks":
    {"0": ...}}, in that order, of the flattened array."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    _put_head(out, 3, 0x80, 15, _MAP_HEAD)
    _put_str(out, CHUNKED)
    out.append(b"\xc3")
    _put_str(out, "shape")
    _put_head(out, arr.ndim, 0x80, 15, _MAP_HEAD)
    for i, d in enumerate(arr.shape):
        _put_str(out, str(i))
        _put_int(out, int(d), "shape")
    _put_str(out, "chunks")
    _put_head(out, len(chunks), 0x80, 15, _MAP_HEAD)
    for i, c in enumerate(chunks):
        _put_str(out, str(i))
        _put_ndarray(out, c, name)


def _pack(out: list, obj, path: str, chunkable: bool):
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        _put_int(out, obj, path)
    elif kind in (bytes, bytearray, memoryview):
        _put_bin(out, obj)
    elif kind is str:
        _put_str(out, obj)
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif kind is dict:
        try:
            keys = sorted(obj)
        except TypeError:
            raise TypeError(f"{path}: dict keys of types that do not "
                            "sort together") from None
        _put_head(out, len(keys), 0x80, 15, _MAP_HEAD)
        for key in keys:
            sub = f"{path}/{key}"
            _pack(out, key, f"{sub} (the key)", False)
            _pack(out, obj[key], sub, chunkable)
    elif kind in (list, tuple):
        _put_head(out, len(obj), 0x90, 15, _ARRAY_HEAD)
        for i, item in enumerate(obj):
            _pack(out, item, f"{path}[{i}]", False)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        arr, name = _host_array(obj, path)
        if chunkable and arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            _put_chunked(out, arr, name)
        else:
            _put_ndarray(out, arr, name)
    elif isinstance(obj, np.generic):
        arr, name = _host_array(np.asarray(obj), path)
        _put_ndarray(out, arr, name, EXT_NPSCALAR)
    elif kind is complex:
        _put_ext(out, EXT_COMPLEX, [b"\x92\xcb" + struct.pack(">d", obj.real)
                                + b"\xcb" + struct.pack(">d", obj.imag)])
    else:
        raise TypeError(f"{path}: a leaf of type {kind.__module__}."
                        f"{kind.__qualname__}, which flax's msgpack does not "
                        "write")


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes (module
    docstring); ``tree`` is left as it is."""
    out: list = []
    _pack(out, tree, "state", True)
    return b"".join(out)


def write_msgpack(path: str, tree: Any) -> str:
    """Write ``msgpack_serialize(tree)`` to the file ``path``."""
    data = msgpack_serialize(tree)
    with open(path, "wb") as f:
        f.write(data)
    return path
