"""The JAX package's checkpoint format, read and written without flax or
msgpack.

A JAX-package checkpoint is `flax.serialization.msgpack_serialize` of a
tree of dicts with str keys and array leaves.  This module holds a decoder
and an encoder for the part of msgpack that flax writes:

- nil, bool, int (every width), float32/64, str, bin, array, map;
- ext type 1, an ndarray: the msgpack of (shape, dtype name, C-order
  bytes);
- ext type 3, a numpy scalar, in the same form with shape ();
- flax's chunked-array record: an array over `MAX_CHUNK_SIZE` bytes is
  written as {"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": flat part, ...}} and read back as one array.

Arrays decode to read-only numpy arrays over the input bytes, except
`bfloat16`, which numpy has no dtype for: it decodes to a torch `bfloat16`
tensor made from the `uint16` bits, never to float32.  The encoder takes
numpy arrays and scalars, torch tensors (bf16 included), dicts, lists
and Python scalars (flax packs with strict types, so a tuple raises), and sorts each dict's keys as flax does (its
`tree_map` copy of the tree rebuilds dicts in sorted key order), so it
gives flax's bytes for the same tree.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader, raw: bool) -> Any:
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack({0xC4: ">B", 0xC5: ">H",
                                      0xC6: ">I"}[b])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r.take(r.unpack({0xD9: ">B", 0xDA: ">H",
                                     0xDB: ">I"}[b])), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _str(data: memoryview, raw: bool):
    return bytes(data) if raw else str(data, "utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> Dict:
    out = {}
    for _ in range(n):
        key = _read(r, raw)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"msgpack map key {key!r} is not a string")
        out[key] = _read(r, raw)
    return out


def _array_from_bytes(data: memoryview):
    r = _Reader(bytes(data))
    shape, name, buffer = _read(r, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name.decode())
                         ).reshape(shape, order="C")


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        x = _array_from_bytes(data)
        return x if isinstance(x, torch.Tensor) else x[()]
    if code == _EXT_COMPLEX:
        re, im = _read(_Reader(bytes(data)), raw=False)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(d: Dict) -> Any:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore`: bytes -> the tree."""
    r = _Reader(data)
    out = _read(r, raw=False)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return _unchunk_tree(out)


def read_checkpoint(path: str) -> Any:
    """The tree of a JAX-package checkpoint file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ------------------------------------------------------------------ encode
def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack(">B", x))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif 0 <= x <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", x))
    elif 0 <= x <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", x))
    elif 0 <= x < 2 ** 64:
        out.append(b"\xcf" + struct.pack(">Q", x))
    elif -0x80 <= x:
        out.append(b"\xd0" + struct.pack(">b", x))
    elif -0x8000 <= x:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif -0x80000000 <= x:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif -2 ** 63 <= x:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_len(out: List[bytes], n: int, fix: Tuple[int, int],
              wide: Tuple[Tuple[int, bytes, str], ...]) -> None:
    """A length header: the fix form below fix[1], else the first wide
    form whose limit holds n."""
    if n < fix[1]:
        out.append(struct.pack(">B", fix[0] | n))
        return
    for limit, tag, fmt in wide:
        if n <= limit:
            out.append(tag + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit msgpack")


_STR = ((0xFF, b"\xd9", ">B"), (0xFFFF, b"\xda", ">H"),
        (0xFFFFFFFF, b"\xdb", ">I"))
_ARRAY = ((0xFFFF, b"\xdc", ">H"), (0xFFFFFFFF, b"\xdd", ">I"))
_MAP = ((0xFFFF, b"\xde", ">H"), (0xFFFFFFFF, b"\xdf", ">I"))


def _pack_str(out: List[bytes], s: str) -> None:
    data = s.encode("utf-8")
    _pack_len(out, len(data), (0xA0, 32), _STR)
    out.append(data)


def _pack_bin(out: List[bytes], data: bytes) -> None:
    n = len(data)
    if n <= 0xFF:
        out.append(b"\xc4" + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + struct.pack(">H", n))
    else:
        out.append(b"\xc6" + struct.pack(">I", n))
    out.append(data)


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n))
    else:
        out.append(b"\xc9" + struct.pack(">I", n))
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_bytes(shape: Tuple[int, ...], name: str, buffer: bytes) -> bytes:
    out: List[bytes] = [b"\x93"]  # the 3-array (shape, name, buffer)
    _pack_len(out, len(shape), (0x90, 16), _ARRAY)
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bin(out, buffer)
    return b"".join(out)


def _leaf_parts(x) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _pack(out: List[bytes], x: Any, in_order: bool = False) -> None:
    """Append x's bytes.  flax's copy of the tree sorts each dict's keys;
    the chunk records it makes after the copy keep their insertion order
    (`in_order`)."""
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is dict:
        if any(type(k) is not str for k in x):
            raise TypeError("map keys must be str")
        in_order = in_order or _CHUNKED in x
        _pack_len(out, len(x), (0x80, 16), _MAP)
        for k in (list(x) if in_order else sorted(x)):
            v = x[k]
            if isinstance(v, (np.ndarray, torch.Tensor)) \
                    and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack_str(out, k)
            _pack(out, v, in_order)
    elif type(x) is list:  # flax packs with strict types: no tuples
        _pack_len(out, len(x), (0x90, 16), _ARRAY)
        for v in x:
            _pack(out, v, in_order)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_bytes(*_leaf_parts(x)))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR,
                  _array_bytes(*_leaf_parts(np.asarray(x))))
    elif type(x) is complex:
        inner: List[bytes] = []
        _pack(inner, [x.real, x.imag])
        _pack_ext(out, _EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """`flax.serialization.msgpack_serialize`: the tree -> bytes."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


def write_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` as a JAX-package checkpoint file."""
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
