"""var_tpu_torch/utils/plotting.py against var_tpu/utils/plotting.py on
the CPU: the port's scene against the JAX package's matplotlib artists,
its PNG, and its exact t-SNE against sklearn's.

Tolerances:
- the scene: exact (the same float64 arithmetic on the same inputs): the
  scatter offsets, each point's class colour and alpha, the marker sizes,
  the wireframe's polylines, the quiver vectors, the status text;
- the PNG: decodes to the frame's size, and each class colour present in
  the scatter appears in it;
- t-SNE (sklearn's TSNE(method="exact", init="pca", random_state=0) on 5
  seeded clusters in 8-D, N = 300): the PCA initialisation within 1e-5 of
  sklearn's (up to each component's sign: sklearn's randomized solver and
  the port's full SVD agree there to float32); the optimisation then runs
  1,000 steps of a chaotic map from that start in another precision
  (sklearn's parameters are float32, the port's float64), so the two
  embeddings are not compared point by point but by what t-SNE is for:
  the final KL divergence within 5% and sklearn's trustworthiness (10
  neighbours) within 0.02.
"""
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from var_tpu_torch.utils import plotting as tplot


def decode_png(data: bytes) -> np.ndarray:
    """An RGB PNG of filter-0 rows (envs/recording.py's), read with zlib
    after checking every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color == 2
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _points(n, d=3, seed=0, classes=5):
    rng = np.random.RandomState(seed)
    p = rng.randn(n, d)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return np.concatenate([p, rng.randint(0, classes, (n, 1))], 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_plot():
    import matplotlib

    matplotlib.use("Agg")
    from var_tpu.utils.plotting import RealTimeEmbeddingPlot

    points = {"img": _points(24, seed=1), "sound": _points(12, seed=2)}
    plot = RealTimeEmbeddingPlot(points, 3, interactive=False)  # JAX's
    yield points, plot
    plot.close()


def test_scene_equals_the_jax_artists(jax_plot):
    points, jplot = jax_plot
    v_img, v_snd = np.array([[0.2, -0.5, 0.4]]), np.array([[0.3, 0.1, -0.9]])
    jplot.draw_arrows(v_img, v_snd, text="pairs 3")
    tplot_ = tplot.RealTimeEmbeddingPlot(points, 3)
    tplot_.draw_arrows(v_img, v_snd, text="pairs 3")
    scene = tplot_.scene
    wire, *rest = jplot.ax.collections
    scatters = [c for c in rest if type(c).__name__ == "Path3DCollection"]
    assert len(scatters) == len(scene.scatters) == 2
    for got, want in zip(scene.scatters, scatters):
        np.testing.assert_array_equal(got.xyz, np.stack(want._offsets3d, 1))
        # the artist's class colours: its cmap over its norm of the labels
        # (get_facecolor reorders by depth once projected)
        np.testing.assert_array_equal(got.colors, want.to_rgba(
            want.get_array(), alpha=want.get_alpha()))
        assert got.size == want.get_sizes()[0]
    assert [s.marker for s in scene.scatters] == ["o", "^"]
    jwire = sorted(np.asarray(s).tobytes() for s in wire._segments3d)
    assert sorted(np.asarray(s).tobytes() for s in scene.wire) == jwire
    for name, jq in (("img", jplot.quiver_img), ("sound", jplot.quiver_sound)):
        q = scene.quivers[name]
        shaft = np.asarray(jq._segments3d)[0]
        np.testing.assert_array_equal(
            sorted(map(tuple, shaft)), sorted(map(tuple, [q.vector,
                                                          np.zeros(3)])))
        np.testing.assert_array_equal(
            np.append(q.color, q.alpha), jq.get_color()[0])
        assert q.width == jq.get_linewidth()[0]
    assert scene.text == jplot.fig_text.get_text()


def test_higher_d_arrows_keep_the_first_three_renormalised():
    from var_tpu.utils.plotting import _first3

    v = np.array([[0.3, -0.4, 0.5, 0.6, 0.2, 0.1, -0.1, 0.05]])
    with pytest.warns(UserWarning, match="first 3"):
        plot = tplot.RealTimeEmbeddingPlot(None, 8)
    plot.draw_arrows(v, v)
    np.testing.assert_array_equal(plot.scene.quivers["img"].vector,
                                  _first3(v[0]))


def test_frames_decode_with_every_class_colour(tmp_path):
    points = {"img": _points(40, seed=3), "sound": _points(20, seed=4)}
    plot = tplot.RealTimeEmbeddingPlot(points, 3)
    plot.draw_arrows(np.array([[0.0, 0.0, 1.0]]))
    path = plot.save(str(tmp_path / "frame.png"))
    img = decode_png(open(path, "rb").read())
    assert img.shape == (tplot.SIZE, tplot.SIZE, 3)
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]
    # each class's colour, opaque where a marker is drawn: a marker at
    # alpha 0.5 over white blends to (c + 1) / 2
    for c in np.unique(points["img"][:, -1]):
        rgb = tplot.class_colors(points["img"][:, -1])[
            points["img"][:, -1] == c][0, :3]
        want = np.rint((rgb * 0.5 + 0.5) * 255).astype(np.uint8)
        assert (np.abs(img.astype(int) - want).sum(-1) <= 3).any(), c
    # the 2-D t-SNE view of a D = 8 set, and the 3-D one, as JAX's
    # plot_representation writes them
    for d in (3, 8):
        pts = {"img": _points(30, d, 5), "sound": _points(15, d, 6)}
        out = tplot.plot_representation(pts, d, str(tmp_path / f"r{d}.png"))
        assert decode_png(open(out, "rb").read()).shape == (
            tplot.SIZE, tplot.SIZE, 3)


@pytest.fixture(scope="module")
def clusters():
    rng = np.random.RandomState(0)
    centers = rng.randn(5, 8) * 6
    labels = np.repeat(np.arange(5), 60)
    return centers[labels] + rng.randn(300, 8), labels


def test_tsne_agrees_with_sklearn(clusters):
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE, trustworthiness

    x, _ = clusters
    pca = PCA(n_components=2, random_state=0).fit_transform(x).astype(
        np.float32)
    pca = pca / np.std(pca[:, 0]) * 1e-4
    mine = tplot.pca_init(torch.from_numpy(x).double()).numpy()
    for j in range(2):
        sign = np.sign(np.dot(mine[:, j], pca[:, j]))
        np.testing.assert_allclose(mine[:, j] * sign, pca[:, j], rtol=0,
                                   atol=1e-5 * np.abs(pca).max())
    ref = TSNE(n_components=2, method="exact", init="pca", random_state=0)
    want = ref.fit_transform(x)
    got, kl = tplot.tsne(x)
    print(f"KL: port {kl:.4f}, sklearn {ref.kl_divergence_:.4f}")
    assert abs(kl - ref.kl_divergence_) <= 0.05 * ref.kl_divergence_
    tw_got = trustworthiness(x, got, n_neighbors=10)
    tw_want = trustworthiness(x, want, n_neighbors=10)
    print(f"trustworthiness: port {tw_got:.4f}, sklearn {tw_want:.4f}")
    assert abs(tw_got - tw_want) <= 0.02


def test_realtime_frames_on_the_reward_wrapper(tmp_path, monkeypatch):
    """realTimeVec on the reward-wrapper path (rl/reward.py) through
    manual control, as the JAX package's wrapper draws it: each step
    rewrites <RLModelSaveDir>/realtime_vec.png with env 0's image and goal
    embeddings as the quivers (a fresh VAR, small widths)."""
    from var_tpu_torch import config as tconfig
    from var_tpu_torch.rl.reward import VecVARReward
    from var_tpu_torch.train.rl import RLTrainer

    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    cfg = tconfig.main_config(env="arms")
    cfg.override(realTimeVec=True, RLTrain=False, RLManualControl=True,
                 RLManualControlLoaded=False, vecEnvBackend="dummy",
                 RLModelSaveDir=str(tmp_path), episodeImgSaveInterval=-1,
                 RLRecurrentSize=32, RLRecurrentInputSize=16,
                 RLActionHiddenSize=32)
    tconfig.gym_register(cfg, env="arms")
    drawn = []
    real = VecVARReward._maybe_draw_realtime

    def spy(self, image_feat, goal_feat):
        drawn.append((image_feat[0].copy(), goal_feat[0].copy()))
        real(self, image_feat, goal_feat)
        quivers = self._rt_plot.scene.quivers
        np.testing.assert_array_equal(quivers["img"].vector, image_feat[0])
        np.testing.assert_array_equal(quivers["sound"].vector, goal_feat[0])

    monkeypatch.setattr(VecVARReward, "_maybe_draw_realtime", spy)
    commands = iter(["0.5 0", "0 -0.5", "quit"])
    trainer = RLTrainer(cfg, env="arms", device="cpu")
    trainer.pretext_model = trainer.pretextObj.init_model(seed=0).eval()
    trainer.manualControl(input_fn=lambda: next(commands))
    assert len(drawn) >= 3  # the reset and each step
    img = decode_png(open(tmp_path / "realtime_vec.png", "rb").read())
    assert img.shape == (tplot.SIZE, tplot.SIZE, 3) and img.std() > 0
