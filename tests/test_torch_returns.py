"""n-step returns port (tianshou_tpu_torch/ops/returns.py) against the JAX
functions on the cases of tests/test_returns.py; float32, rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.ops.returns import nstep_return as jax_nstep_return
from tianshou_tpu.ops.returns import nstep_return_components as jax_nstep_return_components
from tianshou_tpu_torch.ops.returns import nstep_return, nstep_return_components


def _saturated_chains(seed, B=64, n=5):
    rng = np.random.default_rng(seed)
    rews = rng.normal(size=(B, n)).astype(np.float32)
    dones = np.zeros((B, n), np.int32)
    for b in range(B):
        if rng.random() < 0.6:
            k = rng.integers(0, n)
            dones[b, k:] = 1
            rews[b, k + 1:] = rews[b, k]
    q_term = rng.normal(size=B).astype(np.float32)
    return rews, dones, q_term


@pytest.mark.parametrize("seed,n,gamma", [(3, 5, 0.97), (4, 3, 0.99), (5, 1, 0.5)])
def test_nstep_return_matches_jax(seed, n, gamma):
    rews, dones, q = _saturated_chains(seed, n=n)
    ref = np.asarray(jax_nstep_return(jnp.asarray(rews), jnp.asarray(dones), jnp.asarray(q), gamma))
    got = nstep_return(torch.from_numpy(rews), torch.from_numpy(dones), torch.from_numpy(q), gamma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_nstep_return_components_match_jax():
    rews, dones, _ = _saturated_chains(6)
    jr, jd = jax_nstep_return_components(jnp.asarray(rews), jnp.asarray(dones), 0.9)
    tr, td = nstep_return_components(torch.from_numpy(rews), torch.from_numpy(dones), 0.9)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_nstep_one_step_is_td_target():
    got = nstep_return(torch.tensor([[1.0], [2.0]]), torch.tensor([[0], [1]]), torch.tensor([10.0, 10.0]), 0.5)
    ref = jax_nstep_return(jnp.asarray([[1.0], [2.0]]), jnp.asarray([[0], [1]]), jnp.asarray([10.0, 10.0]), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), [6.0, 7.0], rtol=1e-6)
