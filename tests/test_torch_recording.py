"""Episode-image recording (var_tpu_torch/envs/recording.py) and render
mode in the port's host sims, against the JAX package on the CPU.

The JAX package resizes with cv2.resize (INTER_LINEAR) and writes a BGR
JPEG through cv2.imwrite; the port needs neither cv2 nor PIL: its own
bilinear resize and a zlib PNG, RGB, `.png` in place of `.jpg`.

Tolerances:
- the uint8 resize against cv2.resize: equal, value for value (the port
  sums the taps in cv2's 11-bit fixed point, `resize_linear_u8`);
- the PNG decoded with zlib, the interval and naming rules, and the sims'
  trajectories with render=True (observations, the per-step current sound
  drawn from the sim's RandomState, rewards, dones, the recorded frames'
  names): equal.
"""
import os
import struct
import zlib

import numpy as np
import pytest

import var_tpu.config as jconfig
from var_tpu.data.audio_store import AudioStore as JAudioStore
from var_tpu.envs import arm_sim as jarm
from var_tpu.envs import grid_sim as jgrid
from var_tpu.envs import recording as jrec
from var_tpu_torch import config as tconfig
from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs import arm_sim as tarm
from var_tpu_torch.envs import grid_sim as tgrid
from var_tpu_torch.envs import recording as trec
from var_tpu_torch.utils import audio_play

cv2 = pytest.importorskip("cv2")


def _decode_png(data: bytes) -> np.ndarray:
    """A PNG of 8-bit grey or RGB rows with filter 0, read with zlib."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert depth == 8 and color in (0, 2) and b"IEND" in chunks
    c = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every row
    img = rows[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("size", [(224, 224), (480, 480), (50, 70),
                                  (96, 96), (300, 130)])
def test_resize_matches_cv2_within_one_level(size):
    """The arm's and the grid's episodeImgSize (224, 480), a shrink that
    is not cv2's 2x area special case, the identity, a mixed one. The name
    is older than the exact resize: the frames are now equal."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    h, w = size
    got = trec.resize_linear_u8(img, w, h)
    want = cv2.resize(img, (w, h))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    grey = img[..., 0]
    np.testing.assert_array_equal(trec.resize_linear_u8(grey, w, h),
                                  cv2.resize(grey, (w, h)))


@pytest.mark.parametrize("shape", [
    (75, 75, 3), (300, 300, 3), (75, 100, 3), (61, 47, 3), (96, 96, 3),
    (200, 150), (97, 33, 3), (33, 97), (5, 7, 3), (1, 9, 3), (400, 75, 3),
    (192, 192, 3)])
def test_resize_linear_u8_equals_cv2(shape):
    """cv2's fixed-point INTER_LINEAR, bit for bit, on seeded frames: the
    arm's crop (75 x 75) and iTHOR's frame (300 x 300) to 96 x 96, odd
    widths and heights, one channel, the identity and cv2's 2x shrink,
    each also to an upscale and a mixed size."""
    rng = np.random.RandomState(sum(shape))
    for _ in range(5):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        for w, h in ((96, 96), (50, 70), (13, 200)):
            got = trec.resize_linear_u8(img, w, h)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, cv2.resize(img, (w, h)),
                                          err_msg=f"{shape} -> {(h, w)}")
    with pytest.raises(TypeError):
        trec.resize_linear_u8(img.astype(np.float32), 96, 96)


@pytest.mark.parametrize("shape", [(96, 96, 3), (7, 13, 3), (5, 9)])
def test_png_decodes_to_the_array(tmp_path, shape):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = trec.write_png(str(tmp_path / "f.png"), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(_decode_png(f.read()), img)
    assert os.listdir(tmp_path) == ["f.png"]  # no temporary left
    with pytest.raises(ValueError):
        trec.encode_png(np.zeros((4, 4, 2), np.uint8))


class _Cfg:
    def __init__(self, save_dir, interval, size=(224, 224, 3)):
        self.episodeImgSaveDir = str(save_dir)
        self.episodeImgSaveInterval = interval
        self.episodeImgSize = size


@pytest.mark.parametrize("interval", [-1, 0, 1, 3])
def test_interval_and_naming_match_jax(tmp_path, monkeypatch, interval):
    """Which (episode, step) pairs write a frame, under which name, and
    what the frame holds: JAX's array (cv2.imwrite patched to capture it,
    BGR) against the port's PNG (RGB)."""
    captured = {}

    def imwrite(path, img):
        captured[path] = np.array(img)
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    jcfg, tcfg = _Cfg(tmp_path / "jax", interval), _Cfg(tmp_path / "port",
                                                        interval)
    for episode in range(7):
        for step, tag in ((0, ""), (4, "eval_")):
            want = jrec.save_episode_image(jcfg, img, episode, step, tag)
            got = trec.save_episode_image(tcfg, img, episode, step, tag)
            if want is None:
                assert got is None
                continue
            assert os.path.basename(got) == (
                os.path.splitext(os.path.basename(want))[0] + ".png")
            with open(got, "rb") as f:
                frame = _decode_png(f.read())
            np.testing.assert_array_equal(frame, captured[want][..., ::-1])
    expected = 0 if interval <= 0 else 2 * len(range(0, 7, interval))
    assert len(captured) == expected
    port_dir = tmp_path / "port"
    assert (len(os.listdir(port_dir)) if port_dir.exists() else 0) == expected


# -- render mode in the host sims ------------------------------------------------


@pytest.fixture(autouse=True)
def _synthetic_clips(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")


def _configs(env, tmp_path, **extra):
    out = []
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env=env)
        cfg.override(render=True, episodeImgSaveInterval=1,
                     episodeImgSaveDir=str(tmp_path / tag),
                     vecEnvBackend="dummy", **extra)
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _assert_obs_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("env", ["ai2thor", "arms"])
def test_render_trajectories_match_jax(env, tmp_path, monkeypatch):
    """Two whole episodes of each profile's host sim with render=True and
    a frame recorded every step: the per-step current sound (drawn from
    the sim's RandomState only under render) keeps JAX's draw order, so
    every observation is equal; each sim plays its goal command once an
    episode (recorded here in place of a sound device)."""
    played = []
    monkeypatch.setattr(tarm, "play_clip", played.append)
    monkeypatch.setattr(tgrid, "play_clip", played.append)
    steps = 30 if env == "ai2thor" else 6
    if env == "ai2thor":
        jcfg, tcfg = _configs(env, tmp_path, RLEnvMaxSteps=steps,
                              sound_dim=(1, 100, 40))
        jenv, tenv = jgrid.GridHouseSim(jcfg), tgrid.GridHouseSim(tcfg)

        def action(rng):
            return int(rng.randint(len(tcfg.allActions)))
    else:
        jcfg, tcfg = _configs(env, tmp_path, RLEnvMaxSteps=steps)
        jaudio, taudio = JAudioStore(jcfg), AudioStore(tcfg)
        jaudio.loadData()
        taudio.loadData()
        jenv = jarm.FourInARowSim(jcfg, jaudio)
        tenv = tarm.FourInARowSim(tcfg, taudio)

        def action(rng):
            return rng.uniform(-1, 1, 2).astype(np.float32)
    for e in (jenv, tenv):
        # seed 3 walks the grid agent into views of one object
        e.seed(3 if env == "ai2thor" else 11)
    _assert_obs_equal(tenv.reset(), jenv.reset())
    rng = np.random.RandomState(0)
    episodes, heard = 0, 0
    while episodes < 2:
        a = action(rng)
        tout, jout = tenv.step(a), jenv.step(a)
        _assert_obs_equal(tout[0], jout[0])
        assert tout[1:3] == jout[1:3]
        heard += bool(np.any(tout[0]["current_sound"] != 0))
        if tout[2]:
            episodes += 1
            _assert_obs_equal(tenv.reset(), jenv.reset())
        np.testing.assert_array_equal(tenv.render(), jenv.render())
    assert heard  # a current sound was drawn (zeros where no object shows)
    assert len(played) == 3  # the goal of each episode begun
    jnames = sorted(os.path.splitext(n)[0]
                    for n in os.listdir(tmp_path / "jax"))
    tnames = sorted(os.path.splitext(n)[0]
                    for n in os.listdir(tmp_path / "port"))
    assert tnames == jnames and len(tnames) >= 2 * steps
    assert all(n.endswith(".png") for n in os.listdir(tmp_path / "port"))


def test_play_clip_is_a_warned_no_op_without_a_device(monkeypatch):
    monkeypatch.setattr(audio_play, "_sd", None)
    monkeypatch.setitem(__import__("sys").modules, "sounddevice", None)
    with pytest.warns(UserWarning, match="playback disabled"):
        assert audio_play.play_clip(np.zeros(160, np.int16)) is False
    assert audio_play.play_clip(np.zeros(160, np.int16)) is False
