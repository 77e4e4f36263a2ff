"""PNG codec (standard library only) and texture loading."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from banggameengine_tpu.scene.textures import (
    PNG_SIGNATURE, decode_png, encode_png, load_texture_rgba8,
)


def _image(channels, seed=0):
    rng = np.random.default_rng(seed)
    # smooth gradients + noise exercise every filter predictor
    y, x = np.mgrid[0:13, 0:17]
    base = np.stack([x * 15, y * 19, (x + y) * 7, 255 - x * 3], -1)
    img = (base + rng.integers(0, 40, base.shape)) % 256
    return img[..., :channels].astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_round_trip(filter_type, channels):
    img = _image(channels, seed=filter_type)
    data = encode_png(img, filter_type=filter_type)
    assert data[:8] == PNG_SIGNATURE
    out = decode_png(data)
    assert out.shape == img.shape[:2] + (4,)
    np.testing.assert_array_equal(out[..., :channels], img)
    if channels == 3:
        assert (out[..., 3] == 255).all()


def test_decodes_pillow_png(tmp_path):
    """A PNG written by Pillow (adaptive per-row filters) decodes equal."""
    Image = pytest.importorskip("PIL.Image")
    img = _image(4, seed=9)
    path = str(tmp_path / "t.png")
    Image.fromarray(img).save(path, optimize=True)
    np.testing.assert_array_equal(decode_png(open(path, "rb").read()), img)


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


@pytest.mark.parametrize("depth,color,interlace", [
    (16, 6, 0),      # 16-bit
    (8, 3, 0),       # palette
    (8, 6, 1),       # Adam7 interlaced
])
def test_unsupported_png_raises(depth, color, interlace):
    data = (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, color, 0,
                                          0, interlace))
            + _chunk(b"IDAT", zlib.compress(b"\0" * 20))
            + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="only 8-bit"):
        decode_png(data)


def test_load_texture_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = _image(4)
    png = tmp_path / "t.png"
    png.write_bytes(encode_png(img, filter_type=4))
    np.testing.assert_array_equal(load_texture_rgba8(str(png)), img)
    jpg = tmp_path / "t.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ImportError, match="Pillow"):
        load_texture_rgba8(str(jpg))
