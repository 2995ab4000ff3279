"""Kernel B3's plain version (``ops/conv_int8.py``) against the JAX package's
fused int8 conv: the Pallas kernel in interpret mode and its XLA reference,
on the edge cases of ``tests/test_conv_int8_pallas.py`` plus an 8 -> 256
case; the card kernel's tiling, modelled in int64 torch, against both; the
packed weights' layout; the probes' plain versions; the wrappers' shape
checks; and the CPU dispatch of the wrappers.

XLA on the CPU contracts the epilogue ``acc * mult + bias`` into an FMA
(measured: about a quarter of float32 results differ by one ulp from a
separate multiply and add), while the port, like the card's kernel, rounds
the product and the sum separately. An int8 output can therefore differ by
exactly 1 where the value sits within an ulp of a half; the int8 checks
allow that for at most 0.01% of the elements and print the count.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.models.quantized import _CONV_DN
from doubleattentionspeakerverification_tpu.ops.conv_int8_pallas import conv3x3_int8_fused
from doubleattentionspeakerverification_tpu_torch.ops import conv_int8
from doubleattentionspeakerverification_tpu_torch.ops.kernels import BUILD_DIR, CudaKernel
from doubleattentionspeakerverification_tpu_torch.tools import conv_int8_probe, rate_probe


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.partial(jax.jit, static_argnums=4)
def _xla_ref(q, w, mult, bias, out_kind):
    y = jax.lax.conv_general_dilated(q, w, (1, 1), "SAME", dimension_numbers=_CONV_DN,
                                     preferred_element_type=jnp.int32)
    acc = y.astype(jnp.float32) * mult + bias
    if out_kind == "int8":
        return jnp.clip(jnp.round(acc), 0, 127).astype(jnp.int8)
    return jax.nn.relu(acc).astype(jnp.dtype(out_kind))


def _mk(b, t, f, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, t, f, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    mult = (rng.uniform(0.5, 2.0, (cout,)) * 1e-3).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return q, w, mult, bias


def _port(q, w, mult, bias, out_kind):
    cin, cout = w.shape[2], w.shape[3]
    out = conv_int8.conv3x3_int8(torch.from_numpy(q), torch.from_numpy(w.reshape(9, cin, cout)),
                                 torch.from_numpy(mult), torch.from_numpy(bias), out_kind)
    return out.float().numpy() if out_kind == "bfloat16" else out.numpy()


def _assert_matches(got, want, out_kind):
    want = np.asarray(want.astype(jnp.float32) if out_kind == "bfloat16" else want)
    assert got.shape == want.shape
    if out_kind == "int8":
        d = got.astype(np.int32) - want.astype(np.int32)
        n_diff = int(np.count_nonzero(d))
        print(f"int8 elements differing by 1 at round-half ties: {n_diff} of {d.size}")
        assert np.abs(d).max(initial=0) <= 1
        assert n_diff <= 1e-4 * d.size
    elif out_kind == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:   # within one bf16 ulp of the reference
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


CASES = [
    (2, 23, 80, 8, 16, "int8"),       # partial last time tile of the Pallas kernel
    (1, 16, 80, 8, 16, "int8"),       # exact tiling, halo across 2 tiles
    (2, 9, 80, 8, 16, "int8"),        # t barely above one tile
    (1, 7, 80, 8, 16, "int8"),        # t < t_tile (single partial tile)
    (2, 23, 80, 8, 16, "bfloat16"),   # last-conv variant
    (1, 20, 5, 8, 16, "float32"),     # tiny F, f32 out
    (1, 10, 80, 8, 256, "int8"),      # 8 -> 256: several Cout tiles of the Pallas kernel
]


@pytest.mark.parametrize("b,t,f,cin,cout,out_kind", CASES)
def test_plain_matches_pallas_interpret_and_xla(b, t, f, cin, cout, out_kind):
    q, w, mult, bias = _mk(b, t, f, cin, cout)
    got = _port(q, w, mult, bias, out_kind)
    xla = _xla_ref(q, w, mult[None], bias[None], out_kind)
    pallas = conv3x3_int8_fused(q, w.reshape(9, cin, cout), mult[None], bias[None],
                                out_kind=out_kind, interpret=True)
    _assert_matches(got, xla, out_kind)
    _assert_matches(got, pallas, out_kind)


def test_plain_sums_are_exact_at_wide_channels():
    """9·Cin·127² exceeds 2²⁴ for Cin >= 128: the float64 sums stay exact
    integers (checked against int64 arithmetic)."""
    rng = np.random.default_rng(1)
    q = rng.integers(100, 128, (1, 3, 4, 160)).astype(np.int8)
    w9 = rng.integers(100, 128, (9, 160, 8)).astype(np.int8)
    got = conv_int8.conv3x3_int8_sums(torch.from_numpy(q), torch.from_numpy(w9)).numpy()
    xp = np.pad(q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(xp[:, dt:dt + 3, df:df + 4] @ w9[3 * dt + df].astype(np.int64)
               for dt in range(3) for df in range(3))
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got, want.astype(np.float64))


def test_pack_weights_layout():
    """The packed layout unpacks back to w9; input channels past Cin and
    output channels past Cout are zero."""
    rng = np.random.default_rng(2)
    w9 = torch.from_numpy(rng.integers(-127, 128, (9, 40, 130)).astype(np.int8))
    wp = conv_int8.pack_weights(w9)
    assert wp.shape == conv_int8.packed_shape(40, 130) == (2, 2, 9, 16, 2, 8, 16)
    assert wp.is_contiguous()
    # (tile, chunk, tap, group, half, row, byte) -> (tap, chunk*32 + half*16 + byte, tile*128 + group*8 + row)
    unpacked = wp.permute(2, 1, 4, 6, 0, 3, 5).reshape(9, 64, 256)
    assert torch.equal(unpacked[:, :40, :130], w9)
    assert int(unpacked[:, 40:].abs().sum()) == 0          # channels past Cin are zero
    assert int(unpacked[:, :, 130:].abs().sum()) == 0      # outputs past Cout are zero


# CASES plus Cin 1, 3 and 33, Cout 200 (a ragged second N tile) and F 300
# (the patch's three separate bands, F > BM + 2)
TILING_CASES = CASES + [
    (2, 9, 7, 1, 3, "float32"),
    (1, 11, 5, 3, 16, "float32"),
    (1, 3, 80, 33, 200, "float32"),
    (1, 3, 300, 8, 16, "float32"),
]


@pytest.mark.parametrize("b,t,f,cin,cout,out_kind", TILING_CASES)
def test_kernel_tiling_is_exact(b, t, f, cin, cout, out_kind):
    """``conv3x3_int8_tiled`` (the card kernel's tiles, patch bands, tap
    offsets, chunk order and N tail, in int64) equals the plain version bit
    for bit, and the Pallas kernel in interpret mode: its window sums
    exactly at the float32 cases (with mult 1 and bias 2^23 the epilogue
    returns 2^23 + acc, exact for |acc| < 2^23 whether or not XLA contracts
    it into an FMA), its int8 and bfloat16 outputs by the module's rule for
    that contraction. Each Pallas call repeats the shapes, types and
    out_kind of a call made before in this module or this test, so it is
    compiled once."""
    q, w, mult, bias = _mk(b, t, f, cin, cout)
    tq, w9 = torch.from_numpy(q), torch.from_numpy(w.reshape(9, cin, cout))
    wp = conv_int8.pack_weights(w9)
    tm, tb = torch.from_numpy(mult), torch.from_numpy(bias)
    got = conv_int8.conv3x3_int8_tiled(tq, wp, tm, tb, out_kind)
    assert torch.equal(got, conv_int8.conv3x3_int8_plain(tq, w9, tm, tb, out_kind))
    pallas = functools.partial(conv3x3_int8_fused, q, w.reshape(9, cin, cout),
                               out_kind=out_kind, interpret=True)
    if out_kind != "float32":
        got = got.float().numpy() if out_kind == "bfloat16" else got.numpy()
        _assert_matches(got, pallas(mult[None], bias[None]), out_kind)
        return
    one, shift = np.ones(cout, np.float32), np.full(cout, 2.0 ** 23, np.float32)
    sums = conv_int8.conv3x3_int8_tiled(tq, wp, torch.from_numpy(one), torch.from_numpy(shift),
                                        "float32").numpy()
    want = np.asarray(pallas(one[None], shift[None]))
    assert np.abs(want - 2.0 ** 23).max() < 2.0 ** 22
    np.testing.assert_array_equal(sums, want)


def test_wrappers_refuse_shapes_their_kernels_do_not_take():
    """The shape checks of B3's and P1's wrappers, on meta tensors (no data,
    no device): B3 takes any Cin and Cout with weights packed for them; P1
    takes M a multiple of 128, N of 256 and K of 128 bytes."""
    meta = dict(device="meta")
    q = torch.zeros((2, 5, 7, 33), dtype=torch.int8, **meta)
    mult = torch.zeros(200, **meta)
    good = torch.zeros(conv_int8.packed_shape(33, 200), dtype=torch.int8, **meta)
    conv_int8._check(q, good, mult, mult)
    for bad in (torch.zeros(conv_int8.packed_shape(32, 200), dtype=torch.int8, **meta),
                torch.zeros(conv_int8.packed_shape(33, 257), dtype=torch.int8, **meta),
                good.to(torch.int16)):
        with pytest.raises(ValueError, match="w_packed"):
            conv_int8._check(q, bad, mult, mult)
    with pytest.raises(ValueError, match="mult and bias"):
        conv_int8._check(q, good, mult, torch.zeros(199, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        conv_int8.conv3x3_int8(q, torch.zeros((9, 33, 200), dtype=torch.int8, **meta), mult, mult)

    def mats(m, n, k, dtype=torch.int8):
        return torch.zeros((m, k), dtype=dtype, **meta), torch.zeros((n, k), dtype=dtype, **meta)

    rate_probe._check(*mats(128, 256, 128))
    rate_probe._check(*mats(256, 512, 64, torch.bfloat16))
    for m, n, k, dtype in ((64, 256, 128, torch.int8), (128, 128, 128, torch.int8),
                           (128, 256, 96, torch.int8), (128, 256, 32, torch.bfloat16)):
        with pytest.raises(ValueError, match="multiple"):
            rate_probe._check(*mats(m, n, k, dtype))
    with pytest.raises(ValueError, match="CUDA"):
        rate_probe.mm_probe(*mats(128, 256, 128))


def test_cpu_tensors_take_the_plain_version_and_never_build(monkeypatch):
    """On the CPU every wrapper takes its plain version; nothing is compiled
    or loaded and ``_build/`` is not touched. The CUDA wrappers refuse CPU
    tensors."""
    before = sorted(BUILD_DIR.iterdir()) if BUILD_DIR.exists() else None

    def no_build(self):
        raise AssertionError(f"{self.name} tried to build on the CPU")

    monkeypatch.setattr(CudaKernel, "start_build", no_build)
    q, w, mult, bias = _mk(1, 5, 6, 3, 4)
    tq, tw = torch.from_numpy(q), torch.from_numpy(w.reshape(9, 3, 4))
    tm, tb = torch.from_numpy(mult), torch.from_numpy(bias)
    kernels = (conv_int8.KERNEL, rate_probe.KERNEL)
    counts = [k.launches for k in kernels]
    for kind in conv_int8.OUT_KINDS:
        conv_int8.conv3x3_int8(tq, tw, tm, tb, kind)
    a = torch.from_numpy(np.random.default_rng(3).integers(-127, 128, (4, 64), dtype=np.int8))
    rate_probe.mm_probe(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        conv_int8.conv3x3_int8_cuda(tq, conv_int8.pack_weights(tw), tm, tb)
    with pytest.raises(ValueError, match="CUDA"):
        rate_probe.mm_probe_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        conv_int8_probe.variant("full", tq, conv_int8.pack_weights(tw), tm, tb)
    assert [k.launches for k in kernels] == counts
    assert all(k._lib is None for k in kernels)
    assert (sorted(BUILD_DIR.iterdir()) if BUILD_DIR.exists() else None) == before
    with pytest.raises(ValueError, match="out_kind"):
        conv_int8.conv3x3_int8(tq, tw, tm, tb, "float16")


@pytest.mark.parametrize("kind", rate_probe.KINDS)
def test_rate_probe_plain_matches_xla(kind):
    """P1's plain version against the product the Pallas probe computes
    (``jax.lax.dot_general`` with int32 / float32 accumulation)."""
    a, bt = rate_probe.inputs(kind, "cpu", n=64, seed=4)
    got = rate_probe.mm_probe(a, bt).numpy()
    an, bn = a.float().numpy(), bt.float().numpy()
    if kind == "int8":
        an, bn = an.astype(np.int8), bn.astype(np.int8)
        want = jax.lax.dot_general(an, bn.T, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        ab, bb = jnp.asarray(an, jnp.bfloat16), jnp.asarray(bn, jnp.bfloat16)
        want = jax.lax.dot_general(ab, bb.T, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)


def test_conv_probe_full_variant_is_b3_plain_on_cpu():
    """P2's inputs at a small shape: the plain version B3's full variant is
    held to on the card equals the XLA reference."""
    q, w9, mult, bias = conv_int8_probe.inputs("cpu", shape=(1, 6, 40, 16, 16), seed=5)
    got = conv_int8.conv3x3_int8(q, w9, mult, bias).numpy()
    want = _xla_ref(q.numpy(), w9.numpy().reshape(3, 3, 16, 16), mult.numpy()[None],
                    bias.numpy()[None], "int8")
    _assert_matches(got, want, "int8")
