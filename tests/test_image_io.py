"""utils/image.py PNG IO without PIL: round trips, the committed goldens,
and every PNG row filter on read."""

import os
import struct
import zlib

import numpy as np
import pytest

from raytracer_tpu.utils.image import read_png, tonemap, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img, ftype):
    """Reference encoder: every row uses filter `ftype` (PNG spec 9.2)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(int)
    out = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        cur = rows[y].tolist()
        line = []
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][ftype]
            line.append((cur[x] - pred) & 0xFF)
        out.append(ftype)
        out.extend(line)
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_read_every_filter_type(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, ftype))
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_rgb_round_trip(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (13, 17, 3)).astype(
        np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_rgba_round_trip_drops_alpha(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (5, 6, 4)).astype(
        np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")),
                                  img[..., :3])
    # A Paeth-filtered RGBA file decodes too (4 bytes per pixel).
    (tmp_path / "p.png").write_bytes(_encode(img, 4))
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")),
                                  img[..., :3])


def test_float_image_is_tonemapped(tmp_path):
    lin = np.linspace(-0.5, 1.5, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    write_png(str(tmp_path / "t.png"), lin)
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                  tonemap(lin))


def test_reads_committed_golden():
    img = read_png(os.path.join(REPO, "golden", "cornell_64.png"))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert img.max() > 0


def test_image_module_does_not_import_pil():
    import raytracer_tpu.utils.image as image

    with open(image.__file__) as f:
        src = f.read()
    assert "PIL" not in src
