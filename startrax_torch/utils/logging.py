"""Run logging: scalar metrics to JSONL + stdout.

Counterpart of startrax/utils/logging.py, with the same ``metrics.jsonl``
rows and image file names: metrics land in <run_dir>/metrics.jsonl and
images under <run_dir>/images/. The images are 8-bit RGB PNG files that
this module writes itself with zlib and struct (``write_png``, which also
writes RGBA); the
loaders read PNG files with ``read_png``, numpy and zlib, so the port needs
no image library. The test protocol's per-view video is a GIF that
``write_gif`` writes (numpy and its own LZW coder). The JAX package's
optional wandb sink is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import zlib
from typing import Any, Dict

import numpy as np


def configure_logger(run_dir: str, name: str = "startrax") -> logging.Logger:
    """Named logger with a FileHandler on <run_dir>/run.log.

    Loggers are process-global: a second run in the same process reuses the
    name, so the file handler must follow the current run_dir (a stale
    handler would keep appending to the first run's file)."""
    os.makedirs(run_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    path = os.path.abspath(os.path.join(run_dir, "run.log"))
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    have_file = False
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            if h.baseFilename == path:
                have_file = True
            else:
                logger.removeHandler(h)
                h.close()
    if not have_file:
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


def write_png(path: str, rgb: np.ndarray):
    """Write an [H, W, 3] or [H, W, 4] uint8 array as an 8-bit RGB or RGBA
    PNG (colour type 2 or 6; no filtering, one zlib stream)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes [H, W, 3] or [H, W, 4] uint8, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, ch = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, ch * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))


def _gif_palette(frames: np.ndarray):
    """(palette [P <= 256, 3] uint8, indices [T, H, W] uint8) of uint8 RGB
    frames [T, H, W, 3]: their own colours when there are at most 256 of
    them, else the uniform 8 x 8 x 4 RGB cube, each channel rounded to its
    nearest level."""
    colours, inv = np.unique(frames.reshape(-1, 3), axis=0, return_inverse=True)
    if len(colours) <= 256:
        return colours.astype(np.uint8), inv.reshape(frames.shape[:3]).astype(np.uint8)
    levels = (8, 8, 4)
    idx = [np.rint(frames[..., c] / 255.0 * (n - 1)).astype(np.int32)
           for c, n in enumerate(levels)]
    grid = np.meshgrid(*(np.rint(np.arange(n) * 255.0 / (n - 1)) for n in levels), indexing="ij")
    palette = np.stack(grid, axis=-1).reshape(-1, 3).astype(np.uint8)
    return palette, ((idx[0] * levels[1] + idx[1]) * levels[2] + idx[2]).astype(np.uint8)


def _lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's variable-length LZW code of a flat index array: a clear code
    first, codes of 3 to 12 bits packed least significant bit first, a
    clear code whenever the 4096-entry table is full, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size, nxt, table = min_code_size + 1, end + 1, {}
    emit(clear, size)
    data = indices.tolist()
    prefix = data[0]
    for k in data[1:]:
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if nxt < 4096:
            table[(prefix, k)] = nxt
            nxt += 1
            # a decoder adds its entry one code later: it reads the next
            # code one bit wider once this count passes 2^size
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            size, nxt, table = min_code_size + 1, end + 1, {}
        prefix = k
    emit(prefix, size)
    if nxt == (1 << size) and size < 12:
        size += 1  # the decoder's entry for the last code widens the end code
    emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames, duration_ms: int = 250, loop: int = 0):
    """Write uint8 RGB frames (a sequence of [H, W, 3], or [T, H, W, 3]) as
    an animated GIF89a: one global palette of up to 256 colours
    (_gif_palette: exact when the frames hold at most 256 colours), each
    frame shown ``duration_ms`` (in GIF's hundredths of a second), ``loop``
    repetitions (0: for ever, the NETSCAPE2.0 extension)."""
    frames = np.ascontiguousarray(np.stack([np.asarray(f) for f in frames]))
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"write_gif takes uint8 [H, W, 3] frames, got {frames.dtype} "
                         f"{frames.shape[1:]}")
    t, h, w, _ = frames.shape
    palette, indices = _gif_palette(frames)
    depth = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))  # table of 2^depth entries
    table = np.zeros((1 << depth, 3), np.uint8)
    table[:len(palette)] = palette
    min_code_size = max(2, depth)
    delay = int(round(duration_ms / 10.0))
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0x80 | 0x70 | (depth - 1), 0, 0))
        f.write(table.tobytes())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00")
        for i in range(t):
            f.write(b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, delay, 0, 0))
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([min_code_size]))
            code = _lzw(indices[i].reshape(-1), min_code_size)
            for j in range(0, len(code), 255):
                block = code[j:j + 255]
                f.write(bytes([len(block)]) + block)
            f.write(b"\x00")
        f.write(b"\x3b")


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # grey, RGB, grey + alpha, RGBA


def _unfilter(data, filters, bpp):
    """Undo the PNG row filters of data [H, W, C] (int16 filtered bytes)
    with one filter type a row. Each byte depends on its left, upper and
    upper-left neighbours (Sub, Up, Average, Paeth), so the bytes of one
    anti-diagonal y + x = s are decoded together: skewed, with row s
    holding that diagonal, every neighbour is a slice of a row before."""
    h, w, _ = data.shape
    if not filters.any():  # filter type None on every row
        return data
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    raw = np.zeros((h + w, h, bpp), np.int16)
    raw[yy + xx, yy] = data
    out = np.zeros((h + w + 2, h + 1, bpp), np.int16)  # two diagonals before, a zero row above
    sub, up, avg, paeth = ((filters == k)[:, None].astype(np.int16) for k in (1, 2, 3, 4))
    has_paeth = paeth.any()
    for s in range(h + w - 1):
        y0, y1 = max(0, s - w + 1), min(h - 1, s) + 1
        a = out[s + 1, y0 + 1:y1 + 1]  # left
        b = out[s + 1, y0:y1]  # up
        c = out[s, y0:y1]  # up-left
        pred = a * sub[y0:y1] + b * up[y0:y1] + ((a + b) >> 1) * avg[y0:y1]
        if has_paeth:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred += np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)) * paeth[y0:y1]
        out[s + 2, y0 + 1:y1 + 1] = (raw[s, y0:y1] + pred) & 255
    return out[yy + xx + 2, yy + 1]


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG file: grey [H, W], grey + alpha
    [H, W, 2], RGB [H, W, 3] or RGBA [H, W, 4] uint8, with any of the five
    row filters. Raises ValueError naming what it does not read (other bit
    depths, palette colour, interlacing), and on a corrupt file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if ctype == 3:
        raise ValueError(f"{path}: palette PNG (colour type 3) is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if compression or filtering:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    ch = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * ch + 1):
        raise ValueError(f"{path}: {rows.size} image bytes for a {w}x{h}x{ch} image")
    rows = rows.reshape(h, w * ch + 1)
    filters = rows[:, 0].astype(np.int32)
    if (filters > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    img = _unfilter(rows[:, 1:].reshape(h, w, ch).astype(np.int16), filters, ch)
    img = img.astype(np.uint8)
    return img[..., 0] if ch == 1 else img


class MetricsLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fp = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int):
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._fp.write(json.dumps(row) + "\n")
        self._fp.flush()

    def log_image(self, name: str, img: np.ndarray, step: int) -> str:
        """Save a [H, W, 3] float image in [0, 1] under images/ as an 8-bit
        PNG; returns its path."""
        img_dir = os.path.join(self.run_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = (255 * np.clip(np.nan_to_num(np.asarray(img)), 0, 1)).astype(np.uint8)
        path = os.path.join(img_dir, f"{name.replace('/', '_')}_{step:06d}.png")
        write_png(path, arr)
        return path

    def close(self):
        self._fp.close()
