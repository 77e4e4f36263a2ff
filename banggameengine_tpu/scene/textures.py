"""Texture loading: PNG/JPG -> RGBA8 NumPy arrays.

Replaces the reference's stb_image path (``src/render/Texture.cpp:10-40``:
force RGBA8, no mips).  PNG is decoded with the standard library (8-bit
RGB/RGBA, non-interlaced, all five scanline filters); other formats need
Pillow.  Also provides the procedural 2x2 checker fallback
(``src/resource/ResourceManager.cpp:523-539``) and a PNG writer for
generated assets.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit RGB and RGBA only)
_PNG_CHANNELS = {2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, row: bytearray, prior: bytearray, bpp: int):
    """Undo one scanline filter in place (PNG spec, section 9)."""
    n = len(row)
    if ftype == 0:
        return
    if ftype == 1:
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif ftype == 2:
        for i in range(n):
            row[i] = (row[i] + prior[i]) & 0xFF
    elif ftype == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            upleft = prior[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + _paeth(left, prior[i], upleft)) & 0xFF
    else:
        raise ValueError(f"PNG: bad filter type {ftype}")


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA, non-interlaced PNG to uint8[H, W, 4]."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: missing IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"PNG: only 8-bit RGB/RGBA non-interlaced images are supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _PNG_CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG: truncated image data")
    out = bytearray(height * stride)
    prior = bytearray(stride)
    for y in range(height):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prior, bpp)
        out[y * stride:(y + 1) * stride] = row
        prior = row
    img = np.frombuffer(bytes(out), np.uint8).reshape(height, width, bpp)
    if bpp == 3:
        img = np.concatenate(
            [img, np.full((height, width, 1), 255, np.uint8)], axis=-1)
    return img.copy()


def _filter_row(ftype: int, row: bytes, prior: bytes, bpp: int) -> bytes:
    if ftype == 0:
        return row
    out = bytearray(len(row))
    for i in range(len(row)):
        left = row[i - bpp] if i >= bpp else 0
        upleft = prior[i - bpp] if i >= bpp else 0
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior[i]
        elif ftype == 3:
            pred = (left + prior[i]) >> 1
        else:
            pred = _paeth(left, prior[i], upleft)
        out[i] = (row[i] - pred) & 0xFF
    return bytes(out)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """Encode uint8[H, W, 3|4] as an 8-bit RGB/RGBA PNG, every scanline
    with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.ascontiguousarray(img, np.uint8)
    height, width, bpp = img.shape
    color = {3: 2, 4: 6}[bpp]
    stride = width * bpp
    flat = img.tobytes()
    prior = bytes(stride)
    rows = []
    for y in range(height):
        row = flat[y * stride:(y + 1) * stride]
        rows.append(bytes([filter_type]) + _filter_row(filter_type, row,
                                                       prior, bpp))
        prior = row

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 9))
            + chunk(b"IEND", b""))


def load_texture_rgba8(path: str) -> np.ndarray:
    """Decode an image file to uint8[H, W, 4] (RGBA), like stb's forced
    4-channel load."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding '{path}' needs Pillow (only PNG is decoded without "
            "it)") from e
    with Image.open(path) as im:
        im = im.convert("RGBA")
        return np.asarray(im, np.uint8).copy()


def make_checker_rgba8(size: int = 2) -> np.ndarray:
    """Magenta/black checker fallback texture (ResourceManager.cpp:523-539
    uses a 2x2 bright pattern so missing textures are obvious)."""
    y, x = np.mgrid[0:size, 0:size]
    on = ((x + y) % 2 == 0)
    tex = np.zeros((size, size, 4), np.uint8)
    tex[..., 0] = np.where(on, 255, 30)
    tex[..., 1] = np.where(on, 0, 30)
    tex[..., 2] = np.where(on, 255, 30)
    tex[..., 3] = 255
    return tex


def make_white_rgba8() -> np.ndarray:
    """1x1 white texture (Renderer.cpp:208-218 creates one for untextured
    draws)."""
    return np.full((1, 1, 4), 255, np.uint8)


def approx_bytes(tex: np.ndarray) -> int:
    """Parity with TextureLoader.cpp:20-21: W*H*4."""
    return int(tex.shape[0]) * int(tex.shape[1]) * 4
