"""A small PNG reader and writer with zlib and numpy only.

A GPU host may have neither cv2 nor PIL installed. The loader then decodes
PNG content (:func:`is_png`, by its signature, whatever the file's name)
with :func:`read_png` (8-bit grayscale, RGB or RGBA,
non-interlaced; PNG is lossless, so cv2, PIL and this reader give the same
pixels). :func:`write_png` writes 8-bit RGB with filter type 0, for
synthetic test data.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG color type → samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def is_png(path: str) -> bool:
    """Whether the file's content starts with the PNG signature, whatever
    its name (as cv2 and PIL tell formats apart)."""
    with open(path, "rb") as f:
        return f.read(len(_SIGNATURE)) == _SIGNATURE


def png_size(path: str) -> tuple[int, int] | None:
    """(width, height) from the IHDR header, or None if not a PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", head[16:24])


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0)
                   .astype(np.uint8).reshape(-1))
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: each byte needs its left neighbour
            cur = bytearray(stride)
            ln, up = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) // 2 if ftype == 3 else _paeth(a, up[i], c)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG → [H, W, 3] uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    idat = []
    width = height = ctype = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            width, height, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _CHANNELS or interlace != 0:
                raise ValueError(
                    f"{path}: PNG bit depth {depth}, color type {ctype}, interlace "
                    f"{interlace} not supported (8-bit gray/RGB/RGBA, non-interlaced)"
                )
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: PNG without IHDR")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, height, width * bpp, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode [H, W, 3] uint8 as an 8-bit RGB PNG (filter type 0)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
