"""RecordIO — the reference's packed binary dataset format.

Counterpart of ``mxnet_tpu/recordio.py`` (reference
``python/mxnet/recordio.py``: MXRecordIO, MXIndexedRecordIO, IRHeader,
pack/unpack) over dmlc-core's RecordIO framing, pure Python. The on-disk
format is byte-compatible with the reference and with the JAX package,
both ways, so existing ``.rec``/``.idx`` datasets load unchanged:

framing    : [magic u32 = 0xced7230a][lrec u32][data][pad to 4]
             lrec = (cflag << 29) | length; cflag 0 = whole record,
             1/2/3 = first/middle/last chunk of a split record.
header     : IRHeader = struct '<IfQQ' (flag, label, id, id2); flag > 0
             means `flag` float32 extended labels follow the header.

``pack_img``/``unpack_img`` encode and decode through Pillow, imported at
first use; without it they raise ``MXNetError`` naming it. The JAX
package's native chunked reader waits for a later slice (ROADMAP A).
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential reader/writer (reference recordio.py:MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tell(self) -> int:
        return self.record.tell()

    def write(self, buf: bytes):
        if not self.writable:
            raise MXNetError("not writable")
        n = len(buf)
        self.record.write(struct.pack("<II", _MAGIC, n & _LENGTH_MASK))
        self.record.write(buf)
        pad = (4 - (n % 4)) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.writable:
            raise MXNetError("not readable")
        head = self.record.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: bad record magic {magic:#x}")
        cflag = lrec >> _LFLAG_BITS
        length = lrec & _LENGTH_MASK
        data = self.record.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.record.read(pad)
        if cflag in (0,):
            return data
        # chunked record: keep reading continuation chunks (cflag 1..3)
        parts = [data]
        while cflag not in (0, 3):
            head = self.record.read(8)
            magic, lrec = struct.unpack("<II", head)
            cflag = lrec >> _LFLAG_BITS
            length = lrec & _LENGTH_MASK
            parts.append(self.record.read(length))
            pad = (4 - (length % 4)) % 4
            if pad:
                self.record.read(pad)
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer keyed by an .idx sidecar
    (reference recordio.py:MXIndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if getattr(self, "fidx", None) is not None and not self.fidx.closed:
            self.fidx.close()
        super().close()

    def seek(self, idx):
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a header + payload into a record body (reference recordio.py:pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        out = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        out = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Inverse of pack: returns (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def _pil():
    """Pillow's ``Image`` module, imported at first use."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image encoding and decoding need Pillow "
                         "(the PIL package), which is not installed") from e
    return Image


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    """Encode an image (HWC uint8 numpy array) and pack it."""
    import io as _io
    Image = _pil()
    img = np.asarray(img)
    pil = Image.fromarray(img if img.ndim == 3 else img.squeeze())
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kwargs = {"quality": quality} if fmt == "JPEG" else {}
    pil.save(buf, format=fmt, **kwargs)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = -1):
    """Unpack a record into (IRHeader, HWC uint8 image array)."""
    import io as _io
    Image = _pil()
    header, img_bytes = unpack(s)
    pil = Image.open(_io.BytesIO(img_bytes))
    if iscolor == 0:
        pil = pil.convert("L")
    elif iscolor == 1:
        pil = pil.convert("RGB")
    return header, np.asarray(pil)
