"""The port's MHA pooling (kernel B1's plain version) and masked ops against
the JAX package's Pallas kernel (interpret mode) and XLA path."""

import jax
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
