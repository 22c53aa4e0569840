"""Image files without Pillow: 8-bit PNG and binary PGM/PPM in numpy + zlib.

The JAX package reads and writes every image through Pillow
(lsd_slam_tpu/io/dataset.py:40-46, utils/debug_viz.py:60-63,
viewer/stitch.py:24-39). The port reads the lossless formats itself, so a
dataset decodes to the same bytes on every host whether Pillow is
installed or not:

- PNG: bit depth 8, colour types gray, gray+alpha, RGB and RGBA, not
  interlaced, all five row filters (PNG spec section 9);
- PGM/PPM: binary P5/P6 with maxval 255.

Every other file (`.jpg`, `.jpeg`, `.bmp`, `.tif`, and PNG variants
outside the list above: palette, 16-bit, interlaced) is decoded by Pillow
when it imports; without Pillow it raises an error that names the file
and Pillow. Grayscale conversion is Pillow's `convert("L")` bit for bit:
`(R*19595 + G*38470 + B*7471 + 0x8000) >> 16`, alpha ignored.
`read_gray_many` decodes a list of files, undoing the Average and Paeth
row filters of PNGs of one size in one pass (the runner reads its folder
so).

`write_png` writes gray, RGB or RGBA uint8 arrays with filter 0.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_MODES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}


class _NeedsPillow(Exception):
    """A file the built-in codec does not decode."""


def _pillow_read(path: str, mode: str, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            f"{path}: {why}; reading it needs Pillow, which is not "
            f"installed (PNG 8-bit and PGM/PPM P5/P6 need no Pillow)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


_DELTA = None


def _delta_table() -> np.ndarray:
    """(5 * 511 * 511,) int16: each row filter's prediction minus c, at
    (filter * 511 + a - c + 255) * 511 + b - c + 255 (a left, b above, c
    above-left). Sub gives a - c, Up b - c, Average (a + b) >> 1 less c
    (= (a - c + b - c) >> 1, as 2c is even), Paeth a - c, b - c or 0 by
    its rule, which reads only |b - c|, |a - c| and |a + b - 2c|."""
    global _DELTA
    if _DELTA is None:
        d = np.arange(-255, 256, dtype=np.int32)
        da, db = np.meshgrid(d, d, indexing="ij")
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
        paeth = np.where((pa <= pb) & (pa <= pc), da,
                         np.where(pb <= pc, db, 0))
        _DELTA = np.stack([np.zeros_like(da), da, db, (da + db) >> 1,
                           paeth]).astype(np.int16).ravel()
    return _DELTA


def _unfilter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """One image without Average or Paeth rows, row by row."""
    ftype, filt = raw[:, 0], raw[:, 1:].reshape(raw.shape[0], -1, bpp)
    out = filt.copy()
    for y in np.nonzero(ftype)[0]:
        if ftype[y] == 1:
            out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)
        elif y > 0:
            out[y] = filt[y] + out[y - 1]
    return out.reshape(raw.shape[0], -1)


def _unfilter(raws, bpp: int):
    """Undo the PNG row filters of images of one shape: each of `raws` is
    (h, 1 + row_bytes) uint8, each row's filter byte then its bytes;
    returns their (h, row_bytes) pixels.

    Images with only None, Sub and Up rows decode row by row. The others
    decode together, by anti-diagonals x + y = t of pixels: a pixel
    depends only on the pixels left, above and above-left of it, which lie
    on diagonals t-1 and t-2. The images stand side by side as channels of
    one image, skewed so that diagonal t is row t + 2 of `skew`
    (skew[t + 2, y + 1] = pixel (y, t - y), zero-padded); each step reads
    two earlier rows as contiguous slices and looks the prediction up in
    `_delta_table`. The steps are as many for a batch as for one image,
    so a batch costs less per image than one pass each.
    A None row is decoded as a Sub row of its bytes' differences."""
    out = [None] * len(raws)
    slow = []
    for i, raw in enumerate(raws):
        ftype = raw[:, 0]
        if (ftype > 4).any():
            raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
        if np.isin(ftype, (3, 4)).any():
            slow.append(i)
        else:
            out[i] = _unfilter_rows(raw, bpp)
    if not slow:
        return out
    k = len(slow)
    h, row_bytes = raws[slow[0]].shape[0], raws[slow[0]].shape[1] - 1
    w = row_bytes // bpp
    # (h, w, k * bpp): image j's bytes in channels j * bpp ... j * bpp + bpp-1
    filt = np.stack([raws[i][:, 1:].reshape(h, w, bpp) for i in slow],
                    axis=2).reshape(h, w, k * bpp).astype(np.int16)
    ftype = np.stack([raws[i][:, 0] for i in slow], axis=1)     # (h, k)
    none = np.repeat(ftype == 0, bpp, axis=1)                   # (h, k*bpp)
    diff = filt.copy()
    diff[:, 1:] -= filt[:, :-1]
    filt = np.where(none[:, None, :], diff & 0xFF, filt).astype(np.int16)
    ftype = np.repeat(np.where(ftype == 0, 1, ftype), bpp, axis=1)
    base = (ftype.astype(np.int32) * 511 + 255) * 511 + 255
    table = _delta_table()
    yy, xx = np.mgrid[0:h, 0:w]
    fskew = np.zeros((h + w - 1, h, k * bpp), np.int16)
    fskew[yy + xx, yy] = filt
    skew = np.zeros((h + w + 1, h + 1, k * bpp), np.int16)
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h - 1, t) + 1
        a = skew[t + 1, lo + 1:hi + 1]     # left: (y, x - 1)
        b = skew[t + 1, lo:hi]             # above: (y - 1, x)
        c = skew[t, lo:hi]                 # above-left: (y - 1, x - 1)
        idx = np.multiply(a, 511, dtype=np.int32)
        idx += b
        idx -= np.multiply(c, 512, dtype=np.int32)
        idx += base[lo:hi]
        pred = np.take(table, idx)
        pred += c
        pred += fskew[t, lo:hi]
        np.bitwise_and(pred, 0xFF, out=skew[t + 2, lo + 1:hi + 1])
    px = skew[yy + xx + 2, yy + 1].astype(np.uint8).reshape(h, w, k, bpp)
    for j, i in enumerate(slow):
        out[i] = np.ascontiguousarray(px[:, :, j]).reshape(h, row_bytes)
    return out


def _png_rows(path: str, data: bytes):
    """(filtered rows (h, 1 + w * channels) uint8, h, w, colour type)."""
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise _NeedsPillow(f"PNG with bit depth {depth}, colour type "
                           f"{color}, interlace {interlace}")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, not "
                         f"{h * (1 + w * ch)}")
    return raw.reshape(h, 1 + w * ch), h, w, color


def _read_pnm(path: str, data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6), maxval 255 -> (h, w, 1 or 3) uint8."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise _NeedsPillow(f"PNM with maxval {maxval}")
    ch = 1 if data[:2] == b"P5" else 3
    pix = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos + 1)
    return pix.reshape(h, w, ch)


def _decode_many(paths):
    """Per path, (pixels (h, w, c) uint8, Pillow's mode name for them), or
    the _NeedsPillow that says why the built-in codec does not read it.
    PNGs of one size and colour type are unfiltered together."""
    out = [None] * len(paths)
    groups = {}
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            data = f.read()
        try:
            if data[:8] == _PNG_SIG:
                raw, h, w, color = _png_rows(path, data)
                groups.setdefault((h, w, color), []).append((i, raw))
            elif data[:2] in (b"P5", b"P6"):
                px = _read_pnm(path, data)
                out[i] = px, "L" if px.shape[2] == 1 else "RGB"
            else:
                raise _NeedsPillow(f"no built-in decoder for "
                                   f"'{os.path.splitext(path)[1] or path}'")
        except _NeedsPillow as e:
            out[i] = e
    for (h, w, color), items in groups.items():
        ch = _PNG_CHANNELS[color]
        pixels = _unfilter([raw for _, raw in items], ch)
        for (i, _), px in zip(items, pixels):
            out[i] = px.reshape(h, w, ch), _PNG_MODES[color]
    return out


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ITU-R 601-2 luma in 16-bit fixed point, rounded."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _gray(decoded, path: str) -> np.ndarray:
    if isinstance(decoded, _NeedsPillow):
        return _pillow_read(path, "L", str(decoded))
    px, mode = decoded
    if mode in ("L", "LA"):
        return np.ascontiguousarray(px[..., 0])
    return rgb_to_gray(px)


def read_gray(path: str) -> np.ndarray:
    """The image at `path` as (h, w) uint8, as Pillow's
    `Image.open(path).convert("L")` gives it."""
    return _gray(_decode_many([path])[0], path)


def read_gray_many(paths) -> list:
    """`read_gray` of each path; PNGs of one size and colour type decode
    together (see `_unfilter`)."""
    return [_gray(d, p) for d, p in zip(_decode_many(paths), paths)]


def read_rgb(path: str) -> np.ndarray:
    """The image at `path` as (h, w, 3) uint8, as Pillow's
    `Image.open(path).convert("RGB")` gives it."""
    decoded = _decode_many([path])[0]
    if isinstance(decoded, _NeedsPillow):
        return _pillow_read(path, "RGB", str(decoded))
    px, mode = decoded
    if mode in ("L", "LA"):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a (h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA uint8 array as
    an 8-bit PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}.get(ch)
    if color is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, not {ch}")
    rows = np.zeros((h, 1 + w * ch), np.uint8)
    rows[:, 1:] = img.reshape(h, w * ch)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
