"""Quarantine unreadable images (port of the JAX package's
``tools/fix_img_dir.py``; host only).

    python -m clip_assisted_data_labeling_tpu_torch.tools.fix_img_dir --src_folder <dir>

A file is readable where PIL's ``Image.open`` + ``verify()`` passes, as in
the JAX tool. Where PIL is installed the tool asks it; where it is not (a
GPU host may not have it) :func:`verify_image` gives PIL's verdict on PNG
and JPEG content by reading the file's structure, with no pixel decode:

  * the format comes from the magic bytes, not the extension (a PNG named
    ``.jpg`` is a PNG);
  * PNG: the chunks up to ``IEND``, each chunk's CRC checked (``IEND``'s
    own is not, as PIL skips it), an ``IHDR`` of at least 13 bytes with a
    bit depth and color type PIL opens, filter method 0 and a nonzero size
    before the first ``IDAT``, and an ``IDAT`` before ``IEND``
    (``PngImageFile`` opens up to the first ``IDAT``; ``verify`` walks from
    there to ``IEND``);
  * JPEG: the markers up to the start of scan, parsed as PIL's
    ``JpegImageFile`` parses them (each segment's length, a SOF of 8-bit
    samples and 1, 3 or 4 components in whole 3-byte entries with a nonzero
    size, whole
    quantization tables, a JFIF or Adobe segment long enough for its
    version); JPEG's ``verify`` checks nothing beyond what ``Image.open``
    read, so a JPEG cut inside its scan data passes, as under PIL, and one
    cut before its start of scan does not;
  * more than twice PIL's ``MAX_IMAGE_PIXELS`` is unreadable, as PIL raises
    ``DecompressionBombError`` there;
  * any other content is unreadable (PIL may read it: ROADMAP.md, Known
    differences).
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import struct
import zlib

_UNSET = object()
# PIL's Image module, or None without PIL: optional (a GPU host may not have
# it) and imported at the first quarantine run
Image = _UNSET


def _pil():
    global Image
    if Image is _UNSET:
        try:
            from PIL import Image as pil_image
        except ImportError:
            pil_image = None
        Image = pil_image
    return Image


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IS_CID = re.compile(rb"\w\w\w\w").match  # a chunk type, as PIL reads one
# the (bit depth, color type) pairs PIL's PNG reader opens
_PNG_MODES = frozenset({(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3),
                        (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)})
# PIL's Image.MAX_IMAGE_PIXELS: Image.open raises past twice this
_MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

# the markers PIL's JPEG reader knows, by what it does with each
_JPEG_SOF = frozenset({*range(0xFFC0, 0xFFD0), 0xFFDE}) - {0xFFC4, 0xFFC8, 0xFFCC}
_JPEG_SKIP = frozenset({0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDF})
_JPEG_APP = frozenset(range(0xFFE0, 0xFFF0))
_JPEG_BARE = frozenset({0xFFC8, *range(0xFFD0, 0xFFDA), *range(0xFFF0, 0xFFFE)})


class UnreadableImage(ValueError):
    """PIL would not open or verify this file."""


def _read(f, n: int, what: str) -> bytes:
    data = f.read(n) if n > 0 else b""
    if len(data) < max(n, 0):
        raise UnreadableImage(f"truncated {what}")
    return data


def _bomb_check(width: int, height: int) -> None:
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * _MAX_IMAGE_PIXELS:
        raise UnreadableImage(f"Image size ({pixels} pixels) exceeds limit of "
                              f"{2 * _MAX_IMAGE_PIXELS} pixels")


def _verify_png(f) -> None:
    """The PNG's chunks after its signature, as ``Image.open`` and
    ``PngImageFile.verify`` read them."""
    header = None
    seen_idat = False
    while True:
        head = f.read(8)
        if len(head) < 8 or not _IS_CID(head[4:]):
            raise UnreadableImage("truncated PNG file" if len(head) < 8
                                  else f"broken PNG file (chunk {head[4:]!r})")
        (length,), cid = struct.unpack(">I", head[:4]), head[4:]
        if cid == b"IEND":
            break
        data = _read(f, length, f"PNG chunk {cid!r}")
        crc = f.read(4)
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(data, zlib.crc32(cid)):
            raise UnreadableImage(f"broken PNG file (bad header checksum in {cid!r})")
        if cid == b"IHDR" and not seen_idat:
            if length < 13:
                raise UnreadableImage("Truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", data[:13])
            if header[5]:
                raise UnreadableImage("unknown filter category")
        elif cid == b"IDAT" and not seen_idat:
            width, height, depth, ctype = header[:4] if header else (0, 0, 0, 0)
            if (depth, ctype) not in _PNG_MODES or width == 0 or height == 0:
                raise UnreadableImage("cannot identify image file (PNG header)")
            _bomb_check(width, height)
            seen_idat = True
    if not seen_idat:
        raise UnreadableImage("PNG ends before its image data")


def _verify_jpeg(f) -> None:
    """The JPEG's markers after its first three bytes up to the start of
    scan, as PIL's ``JpegImageFile`` parses them."""
    s = b"\xff"
    size = None
    while True:
        if not s:
            raise UnreadableImage("JPEG ends before its start of scan")
        if s[0] != 0xFF:  # junk between segments
            s = f.read(1)
            continue
        s += f.read(1)
        if len(s) < 2:
            raise UnreadableImage("JPEG ends before its start of scan")
        (marker,) = struct.unpack(">H", s)
        if marker == 0xFFFF:  # fill byte
            s = b"\xff"
            continue
        if marker == 0xFF00:  # an escaped 0xFF outside a segment
            s = f.read(1)
            continue
        if marker not in _JPEG_BARE:
            if not (marker in _JPEG_SOF or marker in _JPEG_SKIP or marker in _JPEG_APP
                    or marker in (0xFFDB, 0xFFFE)):
                raise UnreadableImage("no marker found")
            (n,) = struct.unpack(">H", _read(f, 2, "JPEG segment length"))
            body = _read(f, n - 2, "JPEG segment")
            if marker in _JPEG_SOF:
                if len(body) < 6:
                    raise UnreadableImage("truncated JPEG SOF segment")
                bits, height, width, layers = struct.unpack(">BHHB", body[:6])
                if bits != 8:
                    raise UnreadableImage(f"cannot handle {bits}-bit layers")
                if layers not in (1, 3, 4):
                    raise UnreadableImage(f"cannot handle {layers}-layer images")
                if (len(body) - 6) % 3:  # PIL reads the components 3 bytes at a time
                    raise UnreadableImage("truncated JPEG component list")
                size = (width, height)
            elif marker == 0xFFDB:
                while body:
                    qt_length = 1 + (1 if body[0] // 16 == 0 else 2) * 64
                    if len(body) < qt_length:
                        raise UnreadableImage("bad quantization table marker")
                    body = body[qt_length:]
            elif ((marker == 0xFFE0 and body.startswith(b"JFIF"))
                  or (marker == 0xFFEE and body.startswith(b"Adobe"))) and len(body) < 7:
                raise UnreadableImage("truncated JPEG application segment")
            if marker == 0xFFDA:
                break
        s = f.read(1)
    if size is None or size[0] == 0 or size[1] == 0:
        raise UnreadableImage("cannot identify image file (no JPEG frame header)")
    _bomb_check(*size)


def verify_image(path: str) -> None:
    """Raise :class:`UnreadableImage` (or ``OSError``) where PIL's
    ``Image.open`` + ``verify()`` would raise on this PNG or JPEG; any
    other content raises too (see the module docstring)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head == _PNG_SIGNATURE:
            _verify_png(f)
        elif head[:3] == b"\xff\xd8\xff":
            f.seek(3)
            _verify_jpeg(f)
        else:
            raise UnreadableImage(f"cannot identify image file {path!r}")


def _check(path: str) -> None:
    pil = _pil()
    if pil is None:
        verify_image(path)
        return
    with pil.open(path) as img:
        img.verify()


def quarantine_unreadable(src_folder: str, tmp_folder: str,
                          extensions=(".jpg", ".jpeg", ".png")) -> list[str]:
    os.makedirs(tmp_folder, exist_ok=True)
    moved = []
    for file in sorted(os.listdir(src_folder)):
        if not file.lower().endswith(extensions):
            continue
        path = os.path.join(src_folder, file)
        try:
            _check(path)
        except Exception as e:  # any failure to open or verify quarantines the file
            print(f"Error opening {file}: {e}")
            shutil.move(path, os.path.join(tmp_folder, file))
            moved.append(file)
            print(f"Moved {file} to the quarantine folder")
    return moved


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src_folder", required=True)
    parser.add_argument("--tmp_folder", default=None)
    args = parser.parse_args(argv)
    tmp = args.tmp_folder or args.src_folder.rstrip("/") + "_errored"
    quarantine_unreadable(args.src_folder, tmp)


if __name__ == "__main__":
    main()
