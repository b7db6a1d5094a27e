"""The yardstick's arithmetic, tied to the shapes by hand, and read the
same whatever implements the work."""

import math

import pytest

import roofline
from conftest import tiny_run

C = {"sample_rate": 16000, "window_size": 0.001, "window_stride": 0.0005,
     "dim_model": 4, "num_heads": 2, "dim_key": 2, "dim_value": 2, "r": 3,
     "dim_inner": 5, "is_factorized": False, "num_enc_layers": 1,
     "num_dec_layers": 1, "encoder_type": "transformer"}


def test_vgg_block_by_hand():
    # B 2, T 4, F 6, C_in 1 -> C 3: each conv 2 * B*T*F * 9 * C_in * C
    w = roofline.vgg_block_work(2, 4, 6, 1, 3, 4, 2)
    assert w["flops"] == 2 * 48 * 9 * 3 + 2 * 48 * 9 * 9
    # x f32, weights and biases f32, output [2, 2, 3, 3] bf16
    assert w["bytes"] == 48 * 4 + (27 + 3 + 81 + 3) * 4 + 36 * 2
    bytes1 = 8 * 800 * 161 * 4 + (9 * 64 + 64 + 9 * 64 * 64 + 64) * 4 \
        + 8 * 400 * 80 * 64 * 2
    flops1 = 2 * 8 * 800 * 161 * 9 * (64 + 64 * 64)
    bytes2 = 8 * 400 * 80 * 64 * 2 + (9 * 64 * 128 + 128 + 9 * 128 * 128
                                      + 128) * 4 + 8 * 200 * 40 * 128 * 2
    flops2 = 2 * 8 * 400 * 80 * 9 * (64 * 128 + 128 * 128)
    assert roofline.vgg_stack_bound_s(8, 800, 161) == pytest.approx(
        max(bytes1 / 3.35e12, flops1 / 989e12)
        + max(bytes2 / 3.35e12, flops2 / 989e12))


def test_stft_by_hand():
    # B 1, T 3, n_fft 8, hop 4: M 4, 5 M log2 M + 10 * 5 a frame
    w = roofline.stft_fft_work(1, 3, 8, 4)
    assert w["flops"] == 3 * (5 * 4 * 2 + 10 * 5)
    assert w["bytes"] == (16 + 8 + 16 + 15) * 4
    assert roofline.stft_bound_s(1, 3, 8, 4) == w["bytes"] / 3.35e12


def test_model_flops_by_hand():
    # F = 16 * 0.001 * 1000 = 16 bins? n_fft 16 -> 9 bins; T 8 frames
    c = dict(C)
    f = int(c["sample_rate"] * c["window_size"]) // 2 + 1
    assert f == 9
    v = roofline.vgg_flops(c, 1, 8)
    assert v["first"] == 2 * 8 * 9 * 9 * 64
    assert v["rest"] == 2 * 8 * 9 * 9 * 64 * 64 + 2 * 4 * 4 * 9 * (
        64 * 128 + 128 * 128)
    # encoder at T' 2, d_in (9 // 4) * 128 = 256: input linear, then one
    # layer: q, k, v, o through r 3, scores and context, FFN 4 -> 5 -> 4
    tt, d_in = 2, 256
    att = 4 * (2 * tt * 4 * 3 + 2 * tt * 3 * 4) + 2 * 2 * tt * tt * (2 + 2)
    ffn = 2 * tt * 4 * 5 * 2
    assert roofline.encoder_flops(c, 1, 8) == 2 * tt * d_in * 4 + att + ffn
    # training: three times the forward, less the first conv's dX
    fwd = roofline.forward_flops(c, 10, 1, 8, 3)
    assert roofline.train_flops(c, 10, 1, 8, 3) == 3 * fwd - v["first"]
    assert roofline.meta_step_flops(c, 10, 3, 1, 1, 8, 3) == 6 * (
        3 * fwd - v["first"])


def test_decode_flops_grow_with_the_cache():
    c = dict(C)
    one = roofline.decode_flops(c, 10, 1, 8, 1)
    two = roofline.decode_flops(c, 10, 1, 8, 2)
    three = roofline.decode_flops(c, 10, 1, 8, 3)
    # each step adds its own attention over one more cached position
    assert (three - two) - (two - one) == pytest.approx(2 * 2 * 1 * 4)


def test_rooflines_and_mfu_read_the_work_not_the_kernel(bench, tmp_path,
                                                        monkeypatch):
    """The traced work of a meta step is the same when the program runs
    its VGG stack by another implementation (the plain route of
    ``--second-order``)."""
    from mtl_tpu_torch.models import subsampler

    _, a = tiny_run(bench, "meta.flagship", 9, tmp_path / "a", trace=True)
    real = subsampler.FeatureExtractor.forward

    def plain(self, *args, **kwargs):
        self.plain = True
        return real(self, *args, **kwargs)

    monkeypatch.setattr(subsampler.FeatureExtractor, "forward", plain)
    _, b = tiny_run(bench, "meta.flagship", 9, tmp_path / "b", trace=True)
    for key in ("vgg_bound_ms", "stft_bound_ms"):
        assert a.trace[key] == b.trace[key] > 0
    per_step = [a.trace["flops"] / a.trace["steps_in_window"],
                b.trace["flops"] / b.trace["steps_in_window"]]
    assert per_step[0] == per_step[1] > 0
    assert not math.isnan(per_step[0])
