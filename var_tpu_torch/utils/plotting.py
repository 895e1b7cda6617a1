"""Embedding views without matplotlib or sklearn (port of
var_tpu/utils/plotting.py).

The JAX package draws with matplotlib and projects D > 3 with sklearn's
t-SNE; the card's machine has neither, so the port builds the same scene
(the unit-sphere wireframe, the class-coloured scatter, the embedding
quivers) as plain arrays, projects it at matplotlib's default 3-D view
(elevation 30 degrees, azimuth -60, orthographic), rasterizes it with
numpy (discs for images, triangles for sounds, lines for the wireframe
and the quivers) and writes a PNG through envs/recording.py. Text is kept
in the scene but not drawn (there is no font). `tsne` is exact t-SNE in
torch with sklearn's defaults as plot_representation calls it, on any
device.
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# matplotlib's tab10 (matplotlib/_cm.py _tab10_data)
TAB10 = np.array([
    (0x1f, 0x77, 0xb4), (0xff, 0x7f, 0x0e), (0x2c, 0xa0, 0x2c),
    (0xd6, 0x27, 0x28), (0x94, 0x67, 0xbd), (0x8c, 0x56, 0x4b),
    (0xe3, 0x77, 0xc2), (0x7f, 0x7f, 0x7f), (0xbc, 0xbd, 0x22),
    (0x17, 0xbe, 0xcf)], np.float64) / 255.0
# the named colours the JAX package uses: 'lightgray', 'm', 'c'
LIGHTGRAY = (211 / 255, 211 / 255, 211 / 255)
MAGENTA = (0.75, 0.0, 0.75)
CYAN = (0.0, 0.75, 0.75)
ELEV, AZIM = 30.0, -60.0  # matplotlib's default 3-D view, degrees
SIZE = 600  # figsize 6 at 100 dpi, the JAX package's realtime frame


def class_colors(labels, alpha: float = 1.0) -> np.ndarray:
    """RGBA of `labels` as matplotlib's scatter(c=labels, cmap='tab10')
    colours them: the labels normalised over their own min and max, then
    tab10's entry int(x * 10) (9 at x = 1). (N, 4)."""
    c = np.asarray(labels, np.float64).ravel()
    lo, hi = (c.min(), c.max()) if len(c) else (0.0, 0.0)
    x = (c - lo) / (hi - lo) if hi > lo else np.zeros_like(c)
    idx = np.clip((x * 10).astype(np.int64), 0, 9)
    return np.concatenate([TAB10[idx], np.full((len(c), 1), alpha)], 1)


def sphere_wireframe() -> List[np.ndarray]:
    """The unit sphere of np.mgrid[0:2pi:24j, 0:pi:12j] as plot_wireframe
    draws it: one polyline per row (24 of 12 points) and per column (12
    of 24 points)."""
    u, v = np.mgrid[0:2 * np.pi:24j, 0:np.pi:12j]
    x, y, z = np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v)
    grid = np.stack([x, y, z], -1)  # (24, 12, 3)
    return [grid[i] for i in range(24)] + [grid[:, j] for j in range(12)]


def first3(v: np.ndarray) -> np.ndarray:
    """First 3 components, re-normalised when the embedding is higher-D
    (keeps the arrow on the unit sphere); var_tpu's _first3."""
    if len(v) <= 3:
        return v
    v3 = v[:3]
    n = np.linalg.norm(v3)
    return v3 / n if n > 1e-9 else v3


@dataclass
class Scatter:
    xyz: np.ndarray        # (N, 3), or (N, 2) in a 2-D scene
    colors: np.ndarray     # (N, 4) RGBA
    marker: str            # 'o' (images) or '^' (sounds)
    size: float = 20.0     # matplotlib's s, points^2 (3-D default 20)


@dataclass
class Quiver:
    vector: np.ndarray     # (3,), from the origin
    color: Tuple[float, float, float]
    alpha: float
    width: float           # matplotlib's lw, points


@dataclass
class Scene:
    """What a plot holds, as arrays: compared with the JAX package's
    matplotlib artists in tests/test_torch_plotting.py."""
    dims: int = 3
    wire: List[np.ndarray] = field(default_factory=list)
    scatters: List[Scatter] = field(default_factory=list)
    quivers: Dict[str, Quiver] = field(default_factory=dict)
    text: str = ""


def points_scene(points: Optional[dict], alphas=(0.5, 0.5),
                 sound_size: float = 20.0) -> Scene:
    """The 3-D scene of RealTimeEmbeddingPlot (and of plot_representation
    at D <= 3): the wireframe, then the image points (discs) and the sound
    points (triangles), each coloured by its class (the last column)."""
    scene = Scene(3, sphere_wireframe())
    if points:
        for key, marker, alpha, size in (("img", "o", alphas[0], 20.0),
                                         ("sound", "^", alphas[1],
                                          sound_size)):
            p = np.asarray(points[key], np.float64)
            scene.scatters.append(Scatter(p[:, :3], class_colors(
                p[:, -1], alpha), marker, size))
    return scene


# -- projection and rasterizer ----------------------------------------------


def project(xyz: np.ndarray, elev: float = ELEV, azim: float = AZIM
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Orthographic projection at the view (elev, azim): screen (x, y)
    and depth (larger is nearer the viewer)."""
    el, az = math.radians(elev), math.radians(azim)
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az),
                   math.cos(el)])
    eye = np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
                    math.sin(el)])
    xyz = np.asarray(xyz, np.float64)
    return np.stack([xyz @ right, xyz @ up], -1), xyz @ eye


class Canvas:
    """An RGB float image with alpha blending of stamped pixels."""

    def __init__(self, size: int = SIZE):
        self.size = size
        self.rgb = np.ones((size, size, 3))

    def blend(self, ys, xs, color, alpha):
        keep = (ys >= 0) & (ys < self.size) & (xs >= 0) & (xs < self.size)
        ys, xs = ys[keep], xs[keep]
        self.rgb[ys, xs] = (self.rgb[ys, xs] * (1 - alpha)
                            + np.asarray(color)[:3] * alpha)

    def stamp(self, centers: np.ndarray, mask: np.ndarray, colors, alphas):
        """`mask` (offsets (M, 2) as dy, dx) at each of `centers` (N, 2)
        pixels, point by point (so later points cover earlier ones)."""
        for (cy, cx), color, alpha in zip(centers, colors, alphas):
            self.blend(cy + mask[:, 0], cx + mask[:, 1], color, alpha)

    def line(self, a, b, color, alpha, width: int = 1):
        """A segment between pixel positions a and b, `width` pixels."""
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) * 2 + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.rint(a + (b - a) * t).astype(np.int64)
        r = max(width // 2, 0)
        off = np.stack(np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                                   indexing="ij"), -1).reshape(-1, 2)
        pix = np.unique((pts[:, None, :] + off[None]).reshape(-1, 2), axis=0)
        self.blend(pix[:, 0], pix[:, 1], color, alpha)

    def to_uint8(self) -> np.ndarray:
        return np.clip(np.rint(self.rgb * 255), 0, 255).astype(np.uint8)


def _marker(kind: str, size: float) -> np.ndarray:
    """Pixel offsets of a marker of matplotlib size `size` (points^2) at
    100 dpi: a disc ('o') or an upward triangle ('^')."""
    r = max(math.sqrt(size) / 2 * 100 / 72, 1.0)
    k = int(math.ceil(r))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    if kind == "o":
        inside = dy ** 2 + dx ** 2 <= r * r
    else:  # apex up: screen y grows downwards
        inside = (dy >= -r) & (dy <= r / 2) & (
            np.abs(dx) <= (dy + r) * math.tan(math.radians(30)))
    return np.stack([dy[inside], dx[inside]], -1)


def rasterize(scene: Scene, size: int = SIZE) -> np.ndarray:
    """The scene as an (size, size, 3) uint8 image."""
    canvas = Canvas(size)
    if scene.dims == 3:
        lo, hi = np.array([-1.15, -1.15]), np.array([1.15, 1.15])
    else:
        allp = np.concatenate([s.xyz for s in scene.scatters]) \
            if scene.scatters else np.zeros((1, 2))
        lo, hi = allp.min(0), allp.max(0)
        pad = np.maximum((hi - lo) * 0.05, 1e-9)
        lo, hi = lo - pad, hi + pad

    def to_pix(xy):
        f = (xy - lo) / (hi - lo)
        return np.stack([(1 - f[:, 1]) * (size - 1), f[:, 0] * (size - 1)], -1)

    def flat(xyz):
        return project(xyz) if scene.dims == 3 else (xyz, np.zeros(len(xyz)))

    for poly in scene.wire:
        pix = to_pix(flat(poly)[0])
        for a, b in zip(pix[:-1], pix[1:]):
            canvas.line(a, b, LIGHTGRAY, 1.0)
    for s in scene.scatters:
        xy, depth = flat(s.xyz)
        order = np.argsort(depth, kind="stable")  # far first
        centers = np.rint(to_pix(xy)[order]).astype(np.int64)
        canvas.stamp(centers, _marker(s.marker, s.size), s.colors[order, :3],
                     s.colors[order, 3])
    for q in scene.quivers.values():  # 3-D scenes only
        origin = to_pix(project(np.zeros((1, 3)))[0])[0]
        tip = to_pix(project(q.vector[None])[0])[0]
        canvas.line(origin, tip, q.color, q.alpha,
                    max(int(round(q.width * 100 / 72)), 1))
    return canvas.to_uint8()


def save_png(scene: Scene, out_path: str, size: int = SIZE) -> str:
    """The scene rasterized and written as a PNG (envs/recording.py: a
    temporary file, then os.replace, so a reader never sees half a
    frame)."""
    from var_tpu_torch.envs.recording import write_png

    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    return write_png(out_path, rasterize(scene, size))


# -- t-SNE -------------------------------------------------------------------

MACHINE_EPSILON = float(np.finfo(np.double).eps)
# sklearn's TSNE defaults, as plot_representation calls it
PERPLEXITY, EXAGGERATION, MAX_ITER, EXPLORATION = 30.0, 12.0, 1000, 250


def _conditional_p(d2: torch.Tensor, steps: int = 100,
                   tol: float = 1e-5) -> torch.Tensor:
    """sklearn's _binary_search_perplexity, every row at once: the
    Gaussian precision of each row bisected until the row's entropy is
    log(PERPLEXITY). d2: squared distances (N, N), float32 as sklearn
    reads them."""
    n = d2.shape[0]
    d = d2.to(torch.float32).double()
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    want = math.log(PERPLEXITY)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    p = None
    for _ in range(steps):
        p_new = torch.exp(-d * beta[:, None]).masked_fill(eye, 0.0)
        s = p_new.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        h = torch.log(s) + beta * (d * p_new).sum(1) / s
        p_new = p_new / s[:, None]
        p = p_new if p is None else torch.where(done[:, None], p, p_new)
        diff = h - want
        newly = diff.abs() <= tol
        up = ~done & ~newly & (diff > 0)
        down = ~done & ~newly & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2,
                                          (beta + lo) / 2), beta))
        done = done | newly
        if bool(done.all()):
            break
    return p


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """sklearn's init='pca': the centred data's two leading principal
    components (signs as sklearn's svd_flip: each component's largest
    loading positive), scaled so the first has standard deviation 1e-4."""
    xc = x - x.mean(0, keepdim=True)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    vt = vt[:2]
    big = vt.abs().argmax(1)
    signs = torch.sign(vt[torch.arange(len(vt)), big])
    y = xc @ (vt * signs[:, None]).t()
    y = y.to(torch.float32).double()
    return y / y[:, 0].std(unbiased=False) * 1e-4


def kl_and_grad(y: torch.Tensor, p: torch.Tensor, error: bool = True):
    """sklearn's _kl_divergence (exact, one degree of freedom): the KL of
    the joint P (N, N, symmetric, zero diagonal, summing to 1) and the
    Student-t Q of the embedding y (None unless `error`), and its
    gradient."""
    sq = (y * y).sum(1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (y @ y.t()), min=0.0)
    w = (1.0 + d2).reciprocal()
    w.fill_diagonal_(0.0)
    q = torch.clamp(w / w.sum(), min=MACHINE_EPSILON)
    q.fill_diagonal_(1.0)  # log(p / q) = 0 on the diagonal, where p = 0
    kl = None
    if error:
        kl = (p * torch.log(torch.clamp(p, min=MACHINE_EPSILON) / q)).sum()
    pq = (p - q) * w
    return kl, (pq.sum(1, keepdim=True) * y - pq @ y) * 4.0


def tsne(points, device="cpu") -> Tuple[np.ndarray, float]:
    """Exact 2-D t-SNE with sklearn's defaults as TSNE(n_components=2,
    init='pca') runs them: perplexity 30, early exaggeration 12 for the
    first 250 iterations at momentum 0.5, then momentum 0.8 to 1,000,
    learning rate max(N / 12 / 4, 50), sklearn's gains (+0.2 / x0.8,
    floor 0.01), a progress check every 50 iterations (stop after 250
    without progress in the first stage, 300 in the second, or at a
    gradient norm of 1e-7). On `device`: the perplexity search in
    float64, the optimisation in float32 as sklearn's (its parameters are
    float32). Returns the (N, 2) embedding and the final KL divergence."""
    x = torch.as_tensor(np.asarray(points), dtype=torch.float64,
                        device=device)
    n = x.shape[0]
    cond = _conditional_p(torch.cdist(x, x).pow(2))
    p = cond + cond.t()
    p = torch.clamp(p / torch.clamp(p.sum(), min=MACHINE_EPSILON),
                    min=MACHINE_EPSILON)
    p = p.fill_diagonal_(0.0).to(torch.float32)
    y = pca_init(x).to(torch.float32)
    lr = max(n / EXAGGERATION / 4.0, 50.0)
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    kl = float("inf")
    it = 0
    for stage, (momentum, stop, patience) in enumerate(
            ((0.5, EXPLORATION, EXPLORATION), (0.8, MAX_ITER, 300))):
        pe = p * (EXAGGERATION if stage == 0 else 1.0)
        best, best_iter = float("inf"), it
        for i in range(it, stop):
            check = (i + 1) % 50 == 0 or i == stop - 1
            kl_t, grad = kl_and_grad(y, pe, error=check)
            inc = update * grad < 0.0
            gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                                min=0.01)
            grad = grad * gains
            update = momentum * update - lr * grad
            y = y + update
            it = i
            if check:
                kl = float(kl_t)
                if (i + 1) % 50 == 0:
                    if kl < best:
                        best, best_iter = kl, i
                    elif i - best_iter > patience:
                        break
                    if float(grad.norm()) <= 1e-7:
                        break
        it = it + 1
    return y.cpu().numpy(), kl


# -- the JAX package's entry points ------------------------------------------


def plot_representation(points: dict, representation_dim: int,
                        out_path: str, device="cpu") -> str:
    """var_tpu's plot_representation: at D <= 3 the sphere scene (images
    alpha 0.7, sounds size 60), at D > 3 the t-SNE (on `device`) of every
    point's embedding as a 2-D scatter (alpha 0.6); written as a PNG."""
    img, sound = points["img"], points["sound"]
    if representation_dim > 3:
        all_pts = np.concatenate([img[:, :-1], sound[:, :-1]], axis=0)
        emb, _ = tsne(all_pts, device)
        n = len(img)
        scene = Scene(2, [], [
            Scatter(emb[:n], class_colors(img[:, -1], 0.6), "o"),
            Scatter(emb[n:], class_colors(sound[:, -1], 0.6), "^")])
    else:
        scene = points_scene(points, alphas=(0.7, 1.0), sound_size=60.0)
    return save_png(scene, out_path)


class RealTimeEmbeddingPlot:
    """var_tpu's RealTimeEmbeddingPlot, always headless: the port has no
    display backend, so the live view is the frame `save` writes, a PNG
    rewritten atomically (a temporary file, then os.replace) at each
    step; a viewer that reloads the file follows it."""

    def __init__(self, points: Optional[dict], representation_dim: int):
        if representation_dim > 3:
            warnings.warn(
                "RealTimeEmbeddingPlot: representationDim "
                f"{representation_dim} > 3; the live view shows the "
                "L2-normalized first 3 components (the offline "
                "plot_representation uses t-SNE for the full view)")
        self.representation_dim = representation_dim
        self.scene = points_scene(points)

    def draw_arrows(self, v_img=None, v_sound=None, text: str = ""):
        """Replace the quivers: row 0 of each batch, from the origin."""
        self.scene.quivers.clear()
        if v_img is not None:
            self.scene.quivers["img"] = Quiver(
                first3(np.asarray(v_img, np.float64)[0]), MAGENTA, 0.6, 3.0)
        if v_sound is not None:
            self.scene.quivers["sound"] = Quiver(
                first3(np.asarray(v_sound, np.float64)[0]), CYAN, 1.0, 3.0)
        if text:
            self.scene.text = text

    def save(self, out_path: str) -> str:
        return save_png(self.scene, out_path)

    def close(self):
        pass
