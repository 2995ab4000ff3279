"""The frozen arithmetic, pinned to the numbers the port's records give and
held to the port's own copies."""


import pytest

from harness import arith, common

PAPER = common.load_json(common.ROOT, "portbench", "configs", "vgg4l-dmha-paper-f32.json")


def test_paper_forward_and_step_flops():
    assert arith.forward_flops(PAPER, 350) == pytest.approx(45.62853152e9, rel=1e-9)
    assert arith.train_step_flops(PAPER, 350) == pytest.approx(17.52135610368e12, rel=1e-9)


def test_b1_and_b2_bounds_at_the_recorded_shapes():
    # B1: B=8, T'=63, 32 heads of 160, the lengths of the recorded case
    lengths = [63, 1, 19, 54, 29, 54, 11, 10]
    ms, by = arith.bound_ms(arith.b1_bytes(sum(min(n, 63) for n in lengths), 8, 32, 160),
                            4.0 * sum(lengths) * 32 * 160, arith.FP32_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.0015284, rel=1e-4)
    # B2: one 10 s upload
    ms = arith.b2_bytes(160000) / arith.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(0.00028917, rel=1e-4)


@pytest.mark.parametrize("k,heads,t", [(1024, 32, 350), (64, 4, 123), (16, 4, 1000)])
def test_flops_match_the_ports_count(k, heads, t):
    from doubleattentionspeakerverification_tpu_torch.config import ModelConfig
    from doubleattentionspeakerverification_tpu_torch.models.flops import forward_flops_per_sample

    m = {**PAPER, "kernel_size": k, "heads_number": heads}
    cfg = ModelConfig(kernel_size=k, heads_number=heads)
    assert arith.forward_flops(m, t) == forward_flops_per_sample(cfg, t)


def test_b2_constants_match_the_ports_plan():
    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.dsp.features import dft_mel_constants
    from doubleattentionspeakerverification_tpu_torch.ops import logmel

    cfg = FeatureConfig()
    header, table = logmel.pack_plan(logmel.fft_plan(cfg.n_fft))
    bands = logmel.mel_bands(dft_mel_constants(cfg)[2])
    assert arith.B2_PLAN_BYTES == header.nbytes + table.nbytes + bands.nbytes
    assert arith.B2_BAND_BINS == int((bands[:, 1] - bands[:, 0]).sum())


def test_peaks_match_the_ports_table():
    from doubleattentionspeakerverification_tpu_torch.tools import timing

    assert (arith.HBM_BYTES_PER_S, arith.FP32_OPS_PER_S, arith.BF16_OPS_PER_S) == (
        timing.HBM_BYTES_PER_S, timing.FP32_OPS_PER_S, timing.BF16_OPS_PER_S)
