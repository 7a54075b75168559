"""An image's size from its file header, with no pixel decode.

The subset stage gates images by width and height, and a GPU host may have
no PIL. :func:`image_size` asks PIL where it is installed and otherwise
reads the header itself (:func:`header_size`: the PNG IHDR chunk,
``data/png.png_size``, or the JPEG SOF segment). :func:`gray_jpeg_bytes`
makes a valid baseline JPEG of one gray level at any size, in two bits a
block, for synthetic test data.
"""
from __future__ import annotations

import struct

from clip_assisted_data_labeling_tpu_torch.data.png import png_size

_UNSET = object()
# PIL's Image module, or None without PIL: optional (a GPU host may not have
# it) and imported at the first image_size call, so that a reader of headers
# alone (prep, for files it only copies) does not import it
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


# start-of-frame markers: every C0-CF except DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers without a length field: TEM and the restart markers
_STANDALONE = frozenset({0x01, *range(0xD0, 0xD8)})


def jpeg_size(path: str) -> tuple[int, int] | None:
    """(width, height) from a JPEG's SOF segment, or None if the file does
    not start with a JPEG's SOI marker. Raises ValueError when the header
    ends, or the scan starts, before any SOF."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            return None
        while True:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"{path}: JPEG header ends before its SOF")
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":  # fill bytes before a marker
                marker = f.read(1)
            if not marker:
                raise ValueError(f"{path}: JPEG header ends before its SOF")
            code = marker[0]
            if code in _STANDALONE or code == 0x00:
                continue
            if code in (0xD9, 0xDA):
                raise ValueError(f"{path}: JPEG scan or end before any SOF")
            head = f.read(2)
            if len(head) < 2:
                raise ValueError(f"{path}: JPEG header ends before its SOF")
            (length,) = struct.unpack(">H", head)
            if code in _SOF:
                body = f.read(5)
                if len(body) < 5:
                    raise ValueError(f"{path}: truncated JPEG SOF segment")
                _precision, height, width = struct.unpack(">BHH", body)
                return width, height
            f.seek(length - 2, 1)


def header_size(path: str) -> tuple[int, int] | None:
    """(width, height) from a PNG's IHDR or a JPEG's SOF segment, with no
    decoder, or None for any other content."""
    return png_size(path) or jpeg_size(path)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file: PIL's ``size`` where PIL is
    installed, else the PNG or JPEG header, told apart by their signatures.
    Raises (OSError, ValueError, PIL's UnidentifiedImageError) for a file
    that is neither or cannot be read."""
    pil = _pil()
    if pil is not None:
        with pil.open(path) as im:
            return im.size
    size = header_size(path)
    if size is None:
        raise ValueError(f"{path}: neither a PNG nor a JPEG (and no PIL to ask)")
    return size


def gray_jpeg_bytes(width: int, height: int) -> bytes:
    """A baseline grayscale JPEG of ``width`` x ``height`` pixels, all 128:
    every 8x8 block has no AC coefficient and a DC of 0, and both Huffman
    tables hold one 1-bit code (DC category 0, end of block), so each block
    is two zero bits."""
    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    one_code = bytes([1] + [0] * 15) + b"\x00"  # one code of length 1, symbol 0
    blocks = -(-width // 8) * -(-height // 8)
    nbits = 2 * blocks
    data = bytearray(-(-nbits // 8))
    if nbits % 8:  # pad the last byte with 1 bits
        data[-1] = (1 << (8 - nbits % 8)) - 1
    return b"".join((
        b"\xff\xd8",
        segment(0xDB, b"\x00" + bytes([1] * 64)),  # DQT: table 0, all 1
        segment(0xC0, struct.pack(">BHHB", 8, height, width, 1) + b"\x01\x11\x00"),
        segment(0xC4, b"\x00" + one_code),  # DC table 0
        segment(0xC4, b"\x10" + one_code),  # AC table 0
        segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"),  # one component, 0..63
        bytes(data),
        b"\xff\xd9",
    ))
