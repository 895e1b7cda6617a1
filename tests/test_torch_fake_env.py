"""envs/fake.py::FakeArmEnv against the JAX package's: the same spaces,
observations, rewards, dones and frames from the same seed."""
import numpy as np
import pytest

from var_tpu.envs.fake import FakeArmEnv as JFakeArmEnv
from var_tpu_torch.envs.fake import FakeArmEnv


def _spaces_equal(got, want):
    assert list(got.spaces) == list(want.spaces)
    for k, w in want.spaces.items():
        g = got.spaces[k]
        assert (g.shape, np.dtype(g.dtype)) == (w.shape, np.dtype(w.dtype)), k
        np.testing.assert_array_equal(g.low, w.low)
        np.testing.assert_array_equal(g.high, w.high)


@pytest.mark.parametrize("seed,max_steps", [(0, 5), (7, 3)])
def test_fake_arm_env_matches_jax(seed, max_steps):
    kw = dict(max_steps=max_steps, sound_dim=(1, 20, 8), rep_dim=4)
    tenv, jenv = FakeArmEnv(**kw), JFakeArmEnv(**kw)
    _spaces_equal(tenv.observation_space, jenv.observation_space)
    assert tenv.action_space.shape == jenv.action_space.shape == (2,)
    for env in (tenv, jenv):
        env.seed(seed)
    rng = np.random.RandomState(seed)
    for episode in range(2):
        want, got = jenv.reset(), tenv.reset()
        for t in range(max_steps):
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(tenv.render("rgb_array"),
                                          jenv.render("rgb_array"))
            a = rng.uniform(-1, 1, 2).astype(np.float32)
            got, tr, td, _ = tenv.step(a)
            want, jr, jd, _ = jenv.step(a)
            assert (tr, td) == (jr, jd)
            assert td == (t == max_steps - 1)
        assert tenv.episodeCounter == jenv.episodeCounter == episode


def test_unseeded_reset_seeds_zero():
    env = FakeArmEnv()
    obs = env.reset()
    assert env.givenSeed == 0 and obs["image"].shape == (3, 96, 96)
