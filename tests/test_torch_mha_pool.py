"""The port's MHA pooling (kernel B1's plain version) and masked ops against
the JAX package's Pallas kernel (interpret mode) and XLA path."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.models.poolings import init_mha
from doubleattentionspeakerverification_tpu.models.poolings import mha_pool as jax_mha_pool
from doubleattentionspeakerverification_tpu.ops import masked_ops as jm
from doubleattentionspeakerverification_tpu.ops.pooling_pallas import mha_pool_pallas
from doubleattentionspeakerverification_tpu_torch.ops import masked_ops as tm
from doubleattentionspeakerverification_tpu_torch.ops import mha_pool as tp


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


def _setup(b, t, heads, d_h, lengths, seed):
    ht = np.random.default_rng(seed).standard_normal((b, t, heads * d_h)).astype(np.float32)
    params = init_mha(jax.random.PRNGKey(seed), heads * d_h, heads)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    return params, ht, lens


@pytest.mark.parametrize(
    "b, t, heads, d_h, lengths, dk_is_heads",
    [
        (3, 50, 4, 16, [50, 37, 23], True),
        (3, 50, 4, 16, None, True),
        (3, 50, 4, 16, [50, 37, 23], False),
        # ragged rows down to one valid step, T not a multiple of the tile
        (4, 37, 4, 40, [37, 1, 20, 2], True),
    ],
)
def test_plain_matches_pallas_and_xla(b, t, heads, d_h, lengths, dk_is_heads):
    params, ht, lens = _setup(b, t, heads, d_h, lengths, seed=t + d_h)
    cfg = JaxModelConfig(heads_number=heads, mha_dk_is_heads=dk_is_heads)
    ref_xla = np.asarray(jax.jit(jax_mha_pool, static_argnums=3)(params, ht, lens, cfg)[0])
    ref_pallas = np.asarray(
        mha_pool_pallas(params, ht, lens, heads=heads, dk_is_heads=dk_is_heads, t_tile=16)
    )
    got = tp.mha_pool(
        torch.from_numpy(ht), torch.from_numpy(np.array(params["query"])),
        None if lens is None else torch.from_numpy(lens), heads, dk_is_heads,
    ).numpy()
    assert got.shape == (b, heads, d_h)
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5)
    np.testing.assert_allclose(got, ref_xla, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _split_case(b, t, heads, d_h, lengths, bf16, dk_is_heads):
    """Inputs and both JAX references of one split-model case, shared by
    its ranks. A bfloat16 ht goes to Pallas as bfloat16 (it upcasts on
    load, as the split model does) and to XLA as the float32 upcast of the
    same values."""
    params, ht, lens = _setup(b, t, heads, d_h, lengths, seed=7 * t + d_h)
    ht_t = torch.from_numpy(ht)
    if bf16:
        ht_t = ht_t.to(torch.bfloat16)
        ht = ht_t.to(torch.float32).numpy()
    cfg = JaxModelConfig(heads_number=heads, mha_dk_is_heads=dk_is_heads)
    ref_xla = np.asarray(jax.jit(jax_mha_pool, static_argnums=3)(params, ht, lens, cfg)[0])
    ref_pallas = np.asarray(mha_pool_pallas(
        params, jnp.asarray(ht, jnp.bfloat16 if bf16 else jnp.float32), lens,
        heads=heads, dk_is_heads=dk_is_heads, t_tile=16))
    scale = 1.0 / math.sqrt(float(heads if dk_is_heads else d_h))
    q_t = (torch.from_numpy(np.array(params["query"])).t() * scale).contiguous()
    return ht_t.reshape(b, t, heads, d_h), q_t, torch.from_numpy(lens), ref_pallas, ref_xla


@pytest.mark.parametrize("chains", [1, 4])
@pytest.mark.parametrize("ranks", [1, 8])
@pytest.mark.parametrize(
    "b, t, heads, d_h, lengths, bf16, dk_is_heads",
    [
        # rows of length 0, 1, 3 (below R = 8), 13 (not a multiple of R) and T;
        # the shapes of test_plain_matches_pallas_and_xla, whose compiled
        # references the float32 cases reuse
        (3, 50, 4, 16, (50, 0, 13), False, True),
        (3, 50, 4, 16, (50, 0, 13), True, False),
        (4, 37, 4, 40, (1, 3, 37, 0), False, True),
        # T = 1
        (2, 1, 4, 8, (1, 0), True, True),
    ],
)
def test_split_plain_matches_pallas_and_xla(b, t, heads, d_h, lengths, bf16, dk_is_heads, ranks,
                                            chains):
    """The kernel's decomposition (each row's valid steps split over R
    ranks, each rank's over interleaved chains, partial states combined)
    against the Pallas kernel and the XLA path."""
    ht4, q_t, lens, ref_pallas, ref_xla = _split_case(b, t, heads, d_h, lengths, bf16, dk_is_heads)
    got = tp.mha_pool_split_plain(ht4, q_t, lens, ranks, chains).numpy()
    assert got.shape == (b, heads, d_h) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5)
    np.testing.assert_allclose(got, ref_xla, atol=1e-5)
    assert np.all(got[np.asarray(lengths) == 0] == 0)


@pytest.mark.parametrize("chains", [1, 8])
def test_split_plain_equals_plain(chains):
    """At R = 8 the split model is the plain version, to 1e-6, with lengths
    of 0, below 0 and above T (clamped as the kernel clamps them)."""
    rng = np.random.default_rng(21)
    ht4 = torch.from_numpy(rng.standard_normal((7, 37, 4, 16)).astype(np.float32))
    q_t = torch.from_numpy((rng.standard_normal((4, 16)) / 2).astype(np.float32))
    lens = torch.tensor([37, 0, 1, 7, 20, 45, -2], dtype=torch.int32)
    got = tp.mha_pool_split_plain(ht4, q_t, lens, 8, chains)
    np.testing.assert_allclose(got.numpy(), tp.mha_pool_plain(ht4, q_t, lens).numpy(), atol=1e-6)
    assert torch.all(got[1] == 0) and torch.all(got[6] == 0)


def test_launch_plan():
    """The kernel's launch at paper width (H=32, d_h=160): chains of 16 lanes,
    two a warp, one chain a row for every 4 of T; at B=8, T'=7 four heads a
    block of one warp each, from T'=63 eight warps a head; a cluster of two
    ranks only for one or two long rows. Spans that are not whole 16-byte
    pieces take single-value loads; every plan stays within the kernel's
    limits."""
    def key(plan):
        return plan["ranks"], plan["warps_per_head"], plan["heads_per_block"], plan["blocks"]

    assert key(tp.launch_plan(8, 7, 32, 160, 4)) == (1, 1, 4, 64)
    assert key(tp.launch_plan(8, 32, 32, 160, 4)) == (1, 4, 1, 256)
    assert key(tp.launch_plan(8, 63, 32, 160, 4)) == (1, 8, 1, 256)
    assert key(tp.launch_plan(8, 250, 32, 160, 2)) == (1, 8, 1, 256)
    assert key(tp.launch_plan(1, 250, 32, 160, 4)) == (2, 8, 1, 64)
    assert key(tp.launch_plan(4, 250, 32, 160, 4)) == (1, 8, 1, 128)
    assert key(tp.launch_plan(1, 130, 32, 160, 4)) == (1, 8, 1, 32)
    assert tp.launch_plan(8, 63, 32, 160, 4)["vec"] == 4
    assert tp.launch_plan(8, 63, 32, 160, 2)["vec"] == 8
    assert tp.launch_plan(8, 63, 32, 160, 4, ht_ptr=8)["vec"] == 1
    assert tp.launch_plan(3, 20, 3, 5, 4)["vec"] == 1
    assert [tp.chain_lanes(d, 4) for d in (64, 160, 192, 512)] == [8, 16, 16, 32]
    assert [tp.chain_lanes(d, 8) for d in (128, 160, 256, 512)] == [8, 16, 16, 32]
    assert [tp.chain_lanes(d, 1) for d in (5, 40, 64, 160)] == [8, 16, 16, 32]
    for b, t, heads, d_h, elt in ((8, 0, 32, 160, 4), (8, 1000, 32, 160, 4), (1, 4000, 32, 160, 2),
                                  (4, 40, 4, 512, 4), (3, 201, 3, 5, 4), (2, 240, 4, 512, 4)):
        plan = tp.launch_plan(b, t, heads, d_h, elt)
        assert plan["ranks"] in (1, 2) and plan["ranks"] * plan["warps_per_head"] <= tp.MAX_PARTS
        assert plan["warps_per_head"] * plan["heads_per_block"] <= tp.MAX_WARPS
        assert plan["heads_per_block"] * d_h <= tp.MAX_WIDTH
        assert plan["smem"] <= 48 * 1024


def test_plain_upcasts_bfloat16_and_zero_length_rows_give_zeros():
    rng = np.random.default_rng(3)
    ht4 = torch.from_numpy(rng.standard_normal((2, 9, 4, 8)).astype(np.float32))
    q_t = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    lens = torch.tensor([9, 0], dtype=torch.int32)
    out = tp.mha_pool_plain(ht4, q_t, lens)
    assert out.dtype == torch.float32
    assert torch.all(out[1] == 0)
    bf = ht4.to(torch.bfloat16)
    np.testing.assert_allclose(
        tp.mha_pool_plain(bf, q_t, lens).numpy(),
        tp.mha_pool_plain(bf.to(torch.float32), q_t, lens).numpy(), atol=0,
    )


def test_cuda_wrapper_refuses_other_tensors():
    ht4 = torch.zeros((2, 5, 4, 8))
    q_t = torch.zeros((4, 8))
    lens = torch.full((2,), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tp.mha_pool_cuda(ht4, q_t, lens)
    with pytest.raises(ValueError, match="CUDA"):
        tp.mha_pool(torch.zeros((2, 5, 32), device="meta"), torch.zeros((8, 4)), None, 4)
    assert tp.KERNEL.launches == 0


@pytest.mark.parametrize("grad_of", ["ht", "query"])
def test_mha_pool_takes_grad_off_the_cpu(grad_of, monkeypatch):
    """Off the CPU, an input that requires grad under grad mode goes through
    ``MhaPoolFunction`` (whose forward runs with grad off) to the CUDA
    wrapper, with no refusal on the way; the wrapper refuses what is not a
    CUDA tensor."""
    ht = torch.zeros((2, 5, 32), device="meta", requires_grad=grad_of == "ht")
    query = torch.zeros((8, 4), device="meta", requires_grad=grad_of == "query")
    reached = []
    wrapper = tp.mha_pool_cuda

    def spy(*args):
        reached.append(torch.is_grad_enabled())
        return wrapper(*args)

    monkeypatch.setattr(tp, "mha_pool_cuda", spy)
    assert torch.is_grad_enabled()
    with pytest.raises(ValueError, match="needs CUDA"):
        tp.mha_pool(ht, query, None, 4)
    assert reached == [False]
    assert tp.KERNEL.launches == 0


def test_plain_keeps_autograd_on_the_cpu():
    """On the CPU the plain version carries the gradient, equal to jax.grad
    through the XLA pooling."""
    b, t, heads, d_h = 3, 20, 4, 8
    params, ht, _ = _setup(b, t, heads, d_h, None, seed=11)
    lens = np.array([20, 13, 1], np.int32)
    g = np.random.default_rng(12).standard_normal((b, heads, d_h)).astype(np.float32)
    cfg = JaxModelConfig(heads_number=heads)

    def loss(q, x):
        return (jax_mha_pool({**params, "query": q}, x, lens, cfg)[0] * g).sum()

    ref_q, ref_ht = jax.grad(loss, argnums=(0, 1))(params["query"], ht)
    q_t = torch.tensor(np.array(params["query"]), requires_grad=True)
    ht_t = torch.tensor(ht, requires_grad=True)
    (tp.mha_pool(ht_t, q_t, torch.from_numpy(lens), heads) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(ref_q), atol=1e-5)
    np.testing.assert_allclose(ht_t.grad.numpy(), np.asarray(ref_ht), atol=1e-5)


@pytest.mark.parametrize("all_masked_row", [False, True])
def test_masked_ops_match_jax(all_masked_row):
    rng = np.random.default_rng(7)
    scores = rng.standard_normal((3, 11)).astype(np.float32)
    lengths = np.array([11, 4, 0 if all_masked_row else 1], np.int32)
    jmask = np.asarray(jm.length_mask(lengths, 11))
    tmask = tm.length_mask(torch.from_numpy(lengths), 11).numpy()
    np.testing.assert_array_equal(jmask, tmask)
    ref = np.asarray(jm.masked_softmax(scores, jmask, axis=-1))
    got = tm.masked_softmax(torch.from_numpy(scores), torch.from_numpy(tmask), dim=-1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7)
    x = rng.standard_normal((3, 11, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.mask_time(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(jm.mask_time(x, lengths)),
    )
