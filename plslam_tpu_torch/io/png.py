"""A PNG decoder and encoder on zlib and numpy, for the TUM reader
(io/tum.py) and the debug images (io/viewer.py).

The reference decodes and writes with OpenCV, which the card's machine does
not have.
This reads what TUM RGB-D sequences hold and nothing else: non-interlaced
8-bit gray, RGB and RGBA, and 16-bit gray (depth), with all five row
filters. Any other file (interlaced, palette, gray+alpha, 1/2/4-bit,
16-bit colour) raises ValueError rather than return something approximate.

The row filters run on a wavefront: a reconstructed byte depends on its
left, upper and upper-left neighbours, so all pixels of one anti-diagonal
(y + x constant) are reconstructed together, H + W - 1 numpy steps for the
whole image.

`write_png` writes 8-bit gray and 3-channel images with filter type 0 on
every row, taking colour images in BGR order as cv2.imwrite does.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> channels
_FORMATS = {(8, 0): 1, (8, 2): 3, (8, 6): 4, (16, 0): 1}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, H: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9) -> u8[H, row_bytes]."""
    raw = raw.reshape(H, row_bytes + 1)
    ftype = raw[:, 0].astype(np.int64)
    if np.any(ftype > 4):
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    W = row_bytes // bpp
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int64)
    # recon with a zero row above and a zero pixel column on the left
    rec = np.zeros((H + 1, W + 1, bpp), np.int64)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]  # left, up, up-left
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)])
        rec[y + 1, x + 1] = (filt[y, x] + pred[ftype[y], np.arange(len(y))]) & 0xFF
    return rec[1:, 1:].reshape(H, row_bytes).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """-> u8[H, W] (gray), u8[H, W, 3] (RGB, file order), u8[H, W, 4]
    (RGBA) or u16[H, W] (16-bit gray), the samples as stored."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind not in (b"PLTE", b"IEND") and not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, depth, ctype, comp, filt_method, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp != 0 or filt_method != 0:
        raise ValueError(f"{path}: unknown compression or filter method")
    if (depth, ctype) not in _FORMATS:
        raise ValueError(f"{path}: unsupported PNG format (bit depth {depth}, colour type {ctype})")
    ch = _FORMATS[(depth, ctype)]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W * bpp + 1):
        raise ValueError(f"{path}: image data is {raw.size} bytes, expected {H * (W * bpp + 1)}")
    img = _unfilter(raw, H, W * bpp, bpp)
    if depth == 16:
        return img.view(">u2").reshape(H, W).astype(np.uint16)
    return img.reshape(H, W) if ch == 1 else img.reshape(H, W, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, img: np.ndarray) -> None:
    """Write u8[H, W] (gray) or u8[H, W, 3] (BGR, as cv2.imwrite takes it)
    as a PNG file: 8-bit gray or RGB, every row with filter type 0, zlib.
    cv2.imread gives the array back; read_png gives it in file order (RGB
    for a colour image)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes u8[H, W] or u8[H, W, 3], got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rgb = img if img.ndim == 2 else img[..., ::-1]
    raw = np.zeros((H, 1 + rgb[0].size), np.uint8)  # a leading 0: filter type None
    raw[:, 1:] = rgb.reshape(H, -1)
    header = struct.pack(">IIBBBBB", W, H, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                           + _chunk(b"IEND", b""))


def to_gray(img: np.ndarray) -> np.ndarray:
    """An 8-bit image from read_png -> u8[H, W], as cv2.imread(...,
    IMREAD_GRAYSCALE) gives it: libpng's RGB-to-gray with the BT.601
    weights 0.299 / 0.587 in 15-bit fixed point (9797, 19234, 3737),
    truncated; alpha ignored."""
    if img.dtype != np.uint8:
        raise ValueError(f"to_gray takes 8-bit images, got {img.dtype}")
    if img.ndim == 2:
        return img
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"to_gray takes gray, RGB or RGBA images, got shape {img.shape}")
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
