"""Image IO + SSIM quality gate.

PNG write/read with the standard library (zlib + struct); SSIM is a
dependency-free numpy reimplementation of
`skimage.metrics.structural_similarity` with the defaults the reference's
`ssim_compare.py:6-21` relies on (win_size=7 uniform window, K1=0.01,
K2=0.03, channel_axis=2, uint8 data_range=255), so scores are comparable to
the reference's gate.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [0,inf) f32 -> display u8. The reference blits its rgba32f
    accumulation image straight to an sRGB swapchain (UNORM blit performs no
    transfer function), so the honest equivalent is a plain clamp."""
    return (np.clip(linear_rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, image: np.ndarray):
    """image: u8[H,W,3|4] or f32[H,W,3] linear (tonemapped on the way out).
    Writes an 8-bit RGB/RGBA PNG with filter type 0 on every row."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected an [H,W,3|4] image, got {arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(filtered: np.ndarray, h: int, stride: int, bpp: int):
    """Undo the per-row PNG filters (types 0-4) of 8-bit pixel data.
    filtered: u8[h, 1 + stride] rows with the filter byte first."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(filtered[y, 0])
        line = filtered[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth depend on `left`
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB or RGBA PNG as u8[H,W,3] (alpha is
    dropped, as the renderer's images are opaque)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are supported "
            f"(depth {depth}, color type {color_type}, interlace {interlace})")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw.reshape(h, 1 + stride), h, stride, channels)
    return pixels.reshape(h, w, channels)[..., :3].copy()


def write_ppm(path: str, image: np.ndarray):
    """Binary P6 PPM dump — the reference's render-dump format
    (.gitignore:7 ignores *.ppm)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, whitespace-separated w h maxval, single whitespace.
    parts = data.split(maxsplit=4)
    assert parts[0] == b"P6", "only binary P6 PPM supported"
    w, h, maxval = int(parts[1]), int(parts[2]), int(parts[3])
    assert maxval == 255
    pixels = parts[4][: w * h * 3]
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3)


def write_image(path: str, image: np.ndarray):
    """Dispatch on extension (.png or .ppm)."""
    if path.lower().endswith(".ppm"):
        write_ppm(path, image)
    else:
        write_png(path, image)


def read_image(path: str) -> np.ndarray:
    if path.lower().endswith(".ppm"):
        return read_ppm(path)
    return read_png(path)


def _box_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with a win x win window, 'valid' region only, via 2-D
    cumulative sums. img: f64[H,W]."""
    c = np.cumsum(np.cumsum(img, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    oh, ow = h - win + 1, w - win + 1
    s = (
        c[win : win + oh, win : win + ow]
        - c[0:oh, win : win + ow]
        - c[win : win + oh, 0:ow]
        + c[0:oh, 0:ow]
    )
    return s / (win * win)


def _ssim_single(x: np.ndarray, y: np.ndarray, win: int, data_range: float):
    """SSIM for one channel, skimage semantics (uniform filter, unbiased
    covariance, crop win//2 border before averaging)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)

    ux = _box_filter(x, win)
    uy = _box_filter(y, win)
    uxx = _box_filter(x * x, win)
    uyy = _box_filter(y * y, win)
    uxy = _box_filter(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    # skimage computes over the valid region then ignores another pad border;
    # with 'valid' box filtering the result already matches its cropped mean.
    return s.mean(), s


def ssim(image_a: np.ndarray, image_b: np.ndarray, data_range=None,
         win_size: int = 7):
    """Mean SSIM over channels (channel_axis=2), reference gate semantics."""
    a = np.asarray(image_a)
    b = np.asarray(image_b)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
    if data_range is None:
        if a.dtype == np.uint8:
            data_range = 255.0
        else:
            data_range = float(max(a.max() - a.min(), 1e-6))
    if a.ndim == 2:
        return _ssim_single(a, b, win_size, data_range)[0]
    scores = [
        _ssim_single(a[..., c], b[..., c], win_size, data_range)[0]
        for c in range(a.shape[-1])
    ]
    return float(np.mean(scores))
