"""Run logging: scalar metrics to JSONL + stdout.

Counterpart of startrax/utils/logging.py, with the same ``metrics.jsonl``
rows and image file names: metrics land in <run_dir>/metrics.jsonl and
images under <run_dir>/images/. The images are 8-bit RGB PNG files that
this module writes itself with zlib and struct (``write_png``), so the port
needs no image library. The JAX package's optional wandb sink is not ported.
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
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG (no filtering,
    one zlib stream)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))


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
