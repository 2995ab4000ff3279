"""B1's gradient: the port's ``MhaPoolFunction`` (plain forward on the CPU,
torch-op backward) against ``jax.grad`` through the JAX package's XLA
pooling and through ``mha_pool_pallas`` in interpret mode, and the one place
the port departs from the Pallas backward: a row of length 0."""

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.models.poolings import init_mha
from doubleattentionspeakerverification_tpu.models.poolings import mha_pool as jax_mha_pool
from doubleattentionspeakerverification_tpu.ops.pooling_pallas import mha_pool_pallas
from doubleattentionspeakerverification_tpu_torch.ops import mha_pool as tp

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _case(b, t, heads, d_h, seed):
    rng = np.random.default_rng(seed)
    ht = rng.standard_normal((b, t, heads * d_h)).astype(np.float32)
    g = rng.standard_normal((b, heads, d_h)).astype(np.float32)
    query = np.asarray(init_mha(jax.random.PRNGKey(seed), heads * d_h, heads)["query"])
    return ht, query, g


def _port_grads(ht, query, lens, g, heads, dk_is_heads, dtype=torch.float32):
    ht_t = torch.tensor(ht, dtype=dtype, requires_grad=True)
    q_t = torch.tensor(query, requires_grad=True)
    out = tp.mha_pool(ht_t, q_t, None if lens is None else torch.from_numpy(lens), heads,
                      dk_is_heads)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), ht_t.grad, q_t.grad.numpy()


def _jax_grads(pool, query, ht, g):
    """jax.grad of sum(pool(query, ht) * g) -> (d_ht, d_query)."""
    d_q, d_ht = jax.grad(lambda q, x: (pool(q, x) * g).sum(), argnums=(0, 1))(query, ht)
    return np.asarray(d_ht), np.asarray(d_q)


@pytest.mark.parametrize("dk_is_heads", [True, False])
@pytest.mark.parametrize(
    "b, t, heads, d_h, lengths",
    [
        # a row of length 0, one of 1, one equal to T and one above T
        (4, 12, 4, 8, [0, 1, 12, 30]),
        # no lengths: every step valid
        (2, 9, 4, 8, None),
    ],
)
def test_grad_matches_xla(b, t, heads, d_h, lengths, dk_is_heads):
    ht, query, g = _case(b, t, heads, d_h, seed=b + t)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    cfg = JaxModelConfig(heads_number=heads, mha_dk_is_heads=dk_is_heads,
                         use_pallas_pooling=False)
    ref_ht, ref_q = _jax_grads(lambda q, x: jax_mha_pool({"query": q}, x, lens, cfg)[0],
                               query, ht, g)
    _, d_ht, d_q = _port_grads(ht, query, lens, g, heads, dk_is_heads)
    assert d_ht.dtype == torch.float32 and d_ht.shape == ht.shape
    np.testing.assert_allclose(d_ht.numpy(), ref_ht, atol=TOL)
    np.testing.assert_allclose(d_q, ref_q, atol=TOL)
    if lens is not None:
        assert not d_ht[lens == 0].any()


@pytest.mark.parametrize("dk_is_heads", [True, False])
def test_grad_matches_pallas_backward(dk_is_heads):
    """Against the Pallas pooling's own custom_vjp (interpret mode), on a
    batch whose rows all have at least one valid step."""
    b, t, heads, d_h = 3, 20, 4, 8
    ht, query, g = _case(b, t, heads, d_h, seed=5)
    lens = np.array([20, 1, 13], np.int32)

    def pool(q, x):
        return mha_pool_pallas({"query": q}, x, lens, heads=heads, dk_is_heads=dk_is_heads,
                               t_tile=8)

    ref_ht, ref_q = _jax_grads(pool, query, ht, g)
    out, d_ht, d_q = _port_grads(ht, query, lens, g, heads, dk_is_heads)
    np.testing.assert_allclose(out, np.asarray(pool(query, ht)), atol=TOL)
    np.testing.assert_allclose(d_ht.numpy(), ref_ht, atol=TOL)
    np.testing.assert_allclose(d_q, ref_q, atol=TOL)


def test_length_zero_row_differs_from_pallas_backward():
    """Both forwards give a zero context for a row of length 0. The port's
    gradient there is zero, as the XLA path's is; the Pallas backward
    softmaxes the all-masked row to uniform weights and gives it a gradient.
    The other rows agree."""
    b, t, heads, d_h = 2, 8, 4, 8
    ht, query, g = _case(b, t, heads, d_h, seed=9)
    lens = np.array([0, 5], np.int32)

    def pool(q, x):
        return mha_pool_pallas({"query": q}, x, lens, heads=heads, t_tile=8)

    out_pallas = np.asarray(pool(query, ht))
    pallas_ht, _ = _jax_grads(pool, query, ht, g)
    out, d_ht, _ = _port_grads(ht, query, lens, g, heads, True)
    assert not out[0].any() and not out_pallas[0].any()
    assert not d_ht[0].any()
    assert np.abs(pallas_ht[0]).max() > 0.1
    np.testing.assert_allclose(d_ht[1].numpy(), pallas_ht[1], atol=TOL)


def test_backward_equals_autograd_of_plain():
    """``mha_pool_backward`` against torch autograd through ``mha_pool_plain``
    on the same inputs, and bfloat16 ht gets its gradient back in bfloat16."""
    b, t, heads, d_h = 3, 10, 4, 8
    rng = np.random.default_rng(3)
    ht4 = torch.tensor(rng.standard_normal((b, t, heads, d_h)), dtype=torch.float32,
                       requires_grad=True)
    q_t = torch.tensor(rng.standard_normal((heads, d_h)) * 0.5, dtype=torch.float32,
                       requires_grad=True)
    lens = torch.tensor([10, 0, 4], dtype=torch.int32)
    g = torch.tensor(rng.standard_normal((b, heads, d_h)), dtype=torch.float32)
    (tp.mha_pool_plain(ht4, q_t, lens) * g).sum().backward()
    d_ht, d_q = tp.mha_pool_backward(ht4.detach(), q_t.detach(), lens, g)
    torch.testing.assert_close(d_ht, ht4.grad, rtol=0, atol=TOL)
    torch.testing.assert_close(d_q, q_t.grad, rtol=0, atol=TOL)
    d_bf, _ = tp.mha_pool_backward(ht4.detach().to(torch.bfloat16), q_t.detach(), lens, g)
    assert d_bf.dtype == torch.bfloat16
