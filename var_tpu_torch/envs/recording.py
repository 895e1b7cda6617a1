"""Episode image recording (port of var_tpu/envs/recording.py; reference:
fourInARow.py:101-108, RL_env_VAR.py:460-467 saveEpisodeImage).

The JAX package resizes with cv2.resize (INTER_LINEAR) and writes a JPEG
through cv2.imwrite. The port keeps the same interval and naming rules but
needs neither cv2 nor PIL: `resize_bilinear` is cv2's INTER_LINEAR
(half-pixel centres, edge clamping) in numpy, and `write_png` writes a
lossless PNG with zlib from the standard library. So the port's frames are
`<tag><episode>_<step>.png`, in RGB.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _taps(n_out: int, n_in: int):
    """Source indices and weights along one axis, as cv2's INTER_LINEAR:
    the centre of output pixel i maps to (i + 0.5) * n_in / n_out - 0.5,
    clamped to the edges."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0)


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(image, (width, height)) with INTER_LINEAR, for an (H, W)
    or (H, W, C) array; uint8 input is rounded back to uint8 (cv2 sums in
    fixed point, so a value may differ from it by one level)."""
    img = np.asarray(image)
    y0, y1, fy = _taps(height, img.shape[0])
    x0, x1, fx = _taps(width, img.shape[1])
    src = img.astype(np.float64)
    if img.ndim == 3:
        fy, fx = fy[:, None, None], fx[None, :, None]
    else:
        fy, fx = fy[:, None], fx[None, :]
    top = src[y0][:, x0] * (1 - fx) + src[y0][:, x1] * fx
    bottom = src[y1][:, x0] * (1 - fx) + src[y1][:, x1] * fx
    out = top * (1 - fy) + bottom * fy
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) grey or (H, W, 3) RGB uint8 array: 8-bit
    samples, no filter, one zlib stream."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG needs (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> str:
    """Write `image` to `path` as a PNG (through a temporary, so a reader
    never sees half a file). Returns the path."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(encode_png(image))
    os.replace(tmp, path)
    return path


def save_episode_image(config, image_hwc: np.ndarray, episode: int,
                       step: int, tag: str = ""):
    """Write the frame when episodeImgSaveInterval > 0 and the episode index
    is a multiple of it, resized to config.episodeImgSize (h, w, c).
    Returns the path, or None when nothing was written."""
    interval = getattr(config, "episodeImgSaveInterval", -1)
    if interval <= 0 or episode % interval != 0:
        return None
    os.makedirs(config.episodeImgSaveDir, exist_ok=True)
    h, w, _ = config.episodeImgSize
    img = resize_bilinear(image_hwc, w, h)
    path = os.path.join(config.episodeImgSaveDir, f"{tag}{episode}_{step}.png")
    return write_png(path, img)
