"""The port's copy of ``ray_tpu.models.mlm.mask_tokens``: the same
``np.random.Generator`` seed gives the same arrays as the reference's."""

import numpy as np
import pytest

from ray_tpu.models.mlm import mask_tokens as jax_mask_tokens
from ray_tpu_torch.models.mlm import mask_tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("special_ids", [(), (0, 1)])
def test_mask_tokens_matches_reference(seed, special_ids):
    tokens = np.random.RandomState(seed).randint(0, 64, (4, 32))
    kw = dict(mask_id=63, vocab_size=64, mask_prob=0.15,
              special_ids=special_ids)
    want = jax_mask_tokens(tokens, rng=np.random.default_rng(seed), **kw)
    got = mask_tokens(tokens, rng=np.random.default_rng(seed), **kw)
    assert set(got) == set(want) == {"inputs", "targets", "mask"}
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got["mask"].sum(axis=1) >= 1).all()


def test_rare_rows_get_a_forced_prediction_as_in_reference():
    tokens = np.arange(12).reshape(3, 4)
    kw = dict(mask_id=99, vocab_size=100, mask_prob=0.0)
    want = jax_mask_tokens(tokens, rng=np.random.default_rng(5), **kw)
    got = mask_tokens(tokens, rng=np.random.default_rng(5), **kw)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert (got["mask"].sum(axis=1) == 1).all()
