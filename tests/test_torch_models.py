"""The port's arm VAR encoders, weight converter and losses against the JAX
package, on the same numpy-seeded inputs and converted weights.

Tolerance 1e-4: the embeddings are float32 on both sides (the port pins
IEEE float32 convolutions, var_tpu_torch/device.py) and differ only in
summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.models.encoders import VARPretextNet as JaxVAR
from var_tpu.ops import losses as jlosses
from var_tpu_torch.config import main_config
from var_tpu_torch.convert import arm_state_dict, flatten_perm
from var_tpu_torch.models.encoders import (VARPretextNet, build_pretext_model,
                                           conv)
from var_tpu_torch.ops import losses

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def converted():
    rng = np.random.RandomState(0)
    img = rng.rand(4, 3, 96, 96).astype(np.float32)
    snd = (rng.randn(4, 1, 100, 40) * 2).astype(np.float32)
    neg = (rng.randn(4, 1, 100, 40) * 2).astype(np.float32)
    jmodel = JaxVAR(variant="arm", representation_dim=3)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img),
                            jnp.asarray(snd), jnp.asarray(snd))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jout = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(snd),
                        jnp.asarray(neg))
    model = VARPretextNet(3)
    model.load_state_dict(arm_state_dict(params))
    return model, params, (img, snd, neg), jax.tree_util.tree_map(
        np.asarray, jout)


def test_flatten_perm_maps_chw_to_hwc():
    h, w, c = 3, 2, 4
    x = np.random.RandomState(1).randn(h, w, c)
    perm = flatten_perm(h, w, c)
    np.testing.assert_array_equal(x.reshape(-1)[perm],
                                  np.transpose(x, (2, 0, 1)).reshape(-1))


def test_state_dict_covers_every_parameter(converted):
    model, params, _, _ = converted
    sd = arm_state_dict(params)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("key", ["image_feat", "sound_feat_positive",
                                 "sound_feat_negative"])
def test_embeddings_match_jax(converted, key):
    model, _, (img, snd, neg), jout = converted
    with torch.no_grad():
        out = model(torch.from_numpy(img), torch.from_numpy(snd),
                    torch.from_numpy(neg))
    np.testing.assert_allclose(out[key].numpy(), jout[key], **TOL)


def test_encode_image_and_sound_match_jax(converted):
    model, params, (img, snd, _), jout = converted
    with torch.no_grad():
        _, img_f = model.encode_image(torch.from_numpy(img))
        _, snd_f = model.encode_sound(torch.from_numpy(snd))
    np.testing.assert_allclose(img_f.numpy(), jout["image_feat"], **TOL)
    np.testing.assert_allclose(snd_f.numpy(), jout["sound_feat_positive"],
                               **TOL)
    # the VAR reward is their dot product, so it agrees too
    np.testing.assert_allclose(
        (img_f * snd_f).sum(1).numpy(),
        (jout["image_feat"] * jout["sound_feat_positive"]).sum(1), **TOL)


def test_triplet_margin_loss_matches_jax():
    rng = np.random.RandomState(2)
    a, p, n = (rng.randn(16, 3).astype(np.float32) for _ in range(3))
    p[3] = a[3]  # a zero difference: the eps inside the norm
    want = float(jlosses.triplet_margin_loss(jnp.asarray(a), jnp.asarray(p),
                                             jnp.asarray(n), 1.0))
    got = losses.triplet_margin_loss(torch.from_numpy(a), torch.from_numpy(p),
                                     torch.from_numpy(n), 1.0).item()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        losses.pairwise_distance(torch.from_numpy(a),
                                 torch.from_numpy(p)).numpy(),
        np.asarray(jlosses.pairwise_distance(jnp.asarray(a), jnp.asarray(p))),
        **TOL)


def test_l2_normalize_matches_jax_with_zero_rows_and_gradient():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 3).astype(np.float32)
    x[2] = 0.0  # the empty-intent embedding
    w = rng.randn(6, 3).astype(np.float32)
    want = np.asarray(jlosses.l2_normalize(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(
        lambda v: jnp.sum(jlosses.l2_normalize(v) * jnp.asarray(w)))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = losses.l2_normalize(xt)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert not got[2].detach().any()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=1e-4, atol=1e-4)


def test_zero_sound_gives_zero_embedding_with_finite_gradient():
    """Zero-initialised biases map the all-zero empty-intent sound to an
    exactly-zero embedding; l2_normalize keeps its gradient finite."""
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            assert not m.bias.any()
            fan_in = m.weight[0].numel()
            assert m.weight.std().item() < 1.5 / np.sqrt(fan_in)
    _, feat = model.encode_sound(torch.zeros(2, 1, 100, 40))
    assert not feat.any()
    anchor = torch.nn.functional.normalize(torch.ones(2, 3), dim=1)
    losses.triplet_margin_loss(anchor, feat, feat.flip(0) + 0.5).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_model_registry():
    cfg = main_config(env="arms")
    assert isinstance(build_pretext_model(cfg), VARPretextNet)
    cfg.override(pretextModel="ai2thor_VARPretextNet")
    assert build_pretext_model(cfg).variant == "ai2thor"
    cfg.override(pretextModel="arm_VARPretextNet", computeDtype="bfloat16")
    model = build_pretext_model(cfg)
    assert model.dtype == torch.bfloat16
    img = torch.rand(2, 3, 96, 96)
    assert conv(model.img_branch.convs[0], img,
                model.img_branch.dtype).dtype == torch.bfloat16
    raw, feat = model.encode_image(img)
    assert raw.dtype == torch.bfloat16 and feat.dtype == torch.float32
    assert model.encode_sound(torch.randn(2, 1, 100, 40))[0].dtype == \
        torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
