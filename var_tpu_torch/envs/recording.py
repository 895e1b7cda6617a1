"""Episode image recording (port of var_tpu/envs/recording.py; reference:
fourInARow.py:101-108, RL_env_VAR.py:460-467 saveEpisodeImage).

The JAX package resizes with cv2.resize (INTER_LINEAR) and writes a JPEG
through cv2.imwrite. The port keeps the same interval and naming rules but
needs neither cv2 nor PIL: `resize_linear_u8` is cv2's fixed-point
INTER_LINEAR for uint8, value for value (the sims' frames are all
uint8), and `write_png` writes a lossless PNG with zlib from the standard
library. So the port's frames are `<tag><episode>_<step>.png`, in RGB.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


# cv2's INTER_RESIZE_COEF_SCALE: the weights of the uint8 path are integers
# summing to 2048
_COEF = 2048


def _taps_u8(n_out: int, n_in: int, clamp: bool):
    """Source indices and integer weights along one axis, as cv2 computes
    them for uint8: the offset in float32 from the double scale, each
    weight rounded half to even from float32. Columns (`clamp`) put the
    whole weight on the edge pixel outside the image; rows keep their
    weights and only clip the two indices."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= n_in - 1)
        f[edge] = 0
        i0 = np.clip(i0, 0, n_in - 1)
    a0 = np.rint((np.float32(1) - f) * np.float32(_COEF)).astype(np.int64)
    return i0, a0, _COEF - a0


def resize_linear_u8(image: np.ndarray, width: int,
                     height: int) -> np.ndarray:
    """cv2.resize(image, (width, height)) (INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 array, bit for bit: each row is summed in integers
    with 11-bit weights, then two rows are blended as cv2's vector path
    does, ((b0 (r0 >> 4)) >> 16) + ((b1 (r1 >> 4)) >> 16), rounded by
    (+2) >> 2."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 needs uint8, got {img.dtype}")
    h_in, w_in = img.shape[:2]
    x0, a0, a1 = _taps_u8(width, w_in, clamp=True)
    y0, b0, b1 = _taps_u8(height, h_in, clamp=False)
    x1 = np.minimum(x0 + 1, w_in - 1)
    chan = (None,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[(slice(None),) + chan] \
        + src[:, x1] * a1[(slice(None),) + chan]
    r0 = rows[np.clip(y0, 0, h_in - 1)] >> 4
    r1 = rows[np.clip(y0 + 1, 0, h_in - 1)] >> 4
    col = (slice(None), None) + chan
    out = (((b0[col] * r0) >> 16) + ((b1[col] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


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
    img = resize_linear_u8(image_hwc, w, h)
    path = os.path.join(config.episodeImgSaveDir, f"{tag}{episode}_{step}.png")
    return write_png(path, img)
