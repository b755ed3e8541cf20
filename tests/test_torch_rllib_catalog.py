"""The port's model catalog under the reference's
tests/test_rllib_catalog.py (catalog resolution, the custom-model
registry, the GRU's unroll), params on the CPU. The R2D2 cases wait for
r2d2's port.
"""

import numpy as np
import pytest
import torch
from torch_port_util import one_torch_thread  # noqa: F401


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class TestCatalog:
    def test_mlp_default(self):
        from ray_tpu_torch.rllib import ModelSpec, get_model

        init, fwd = get_model(ModelSpec(4, 2))
        params = init(_gen(0), device="cpu")
        logits, value = fwd(params, torch.zeros((3, 4)))
        assert logits.shape == (3, 2) and value.shape == (3,)

    def test_conv_for_plane_observations(self):
        from ray_tpu_torch.rllib import ModelSpec, get_model

        spec = ModelSpec(400, 3, obs_planes=(4, 10, 10))
        init, fwd = get_model(spec, {"type": "conv",
                                     "conv_filters": (8, 16)})
        params = init(_gen(0), device="cpu")
        logits, value = fwd(params, torch.zeros((5, 400)))
        assert logits.shape == (5, 3) and value.shape == (5,)
        # conv params exist and the net is sensitive to spatial structure
        assert any(k.startswith("cw") for k in params)
        obs = np.zeros((1, 400), np.float32)
        obs2 = obs.copy()
        obs2[0, 37] = 1.0  # one cell lights up
        l1, _ = fwd(params, torch.from_numpy(obs))
        l2, _ = fwd(params, torch.from_numpy(obs2))
        assert not np.allclose(np.asarray(l1), np.asarray(l2))

    def test_custom_model_registry(self):
        from ray_tpu_torch.rllib import ModelSpec, get_model, \
            register_custom_model

        def my_init(rng, spec, cfg):
            return {"w": torch.ones((spec.obs_dim, spec.num_actions))}

        def my_fwd(params, obs):
            logits = obs @ params["w"]
            return logits, logits.sum(-1)

        register_custom_model("test_linear", my_init, my_fwd)
        init, fwd = get_model(ModelSpec(3, 2), {"type": "test_linear"})
        logits, _ = fwd(init(_gen(0), device="cpu"), torch.ones((1, 3)))
        np.testing.assert_allclose(np.asarray(logits), [[3.0, 3.0]])

    def test_unknown_type_raises(self):
        from ray_tpu_torch.rllib import ModelSpec, get_model

        with pytest.raises(ValueError, match="unknown model type"):
            get_model(ModelSpec(3, 2), {"type": "nope"})


class TestGRU:
    def test_unroll_matches_stepwise(self):
        from ray_tpu_torch.rllib import gru_forward, gru_unroll, init_gru

        params = init_gru(_gen(0), 4, 2, hidden=8, device="cpu")
        T, B = 5, 3
        obs = torch.randn((T, B, 4), generator=_gen(1))
        h = torch.zeros((B, 8))
        step_logits = []
        for t in range(T):
            lt, _, h = gru_forward(params, obs[t], h)
            step_logits.append(lt)
        logits, _, h_final = gru_unroll(params, obs, torch.zeros((B, 8)))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(torch.stack(step_logits)),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(h), np.asarray(h_final),
                                   rtol=2e-5, atol=2e-5)

    def test_reset_clears_carry(self):
        from ray_tpu_torch.rllib import gru_unroll, init_gru

        params = init_gru(_gen(0), 4, 2, hidden=8, device="cpu")
        T, B = 4, 1
        obs = torch.randn((T, B, 4), generator=_gen(1))
        # reset at t=2: steps 2..3 must equal a fresh unroll of obs[2:]
        reset = torch.tensor([[False], [False], [True], [False]])
        logits_r, _, _ = gru_unroll(params, obs, torch.zeros((B, 8)), reset)
        logits_f, _, _ = gru_unroll(params, obs[2:], torch.zeros((B, 8)))
        np.testing.assert_allclose(np.asarray(logits_r[2:]),
                                   np.asarray(logits_f),
                                   rtol=2e-5, atol=2e-5)
