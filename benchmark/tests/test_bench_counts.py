"""The counts of work against shapes worked by hand."""

from __future__ import annotations

import pytest

from counts import peaks, sae, whisper


def test_sae_forward_at_whisper_tiny_8x():
    b, d, h, k = 32768, 384, 3072, 32
    # encode 2*32768*384*3072 = 77,309,411,328; decode 2*32768*32*384 = 805,306,368
    assert sae.forward_flops(b, d, h, k) == 78_114_717_696
    assert sae.forward_alu_ops(b, h) == 100_663_296
    # rows 50,331,648 + params (2*384*3072 + 3072 + 2*384)*4 = 9,452,544
    # + k values and indices 32768*32*6 = 6,291,456 + f32 residual 50,331,648
    assert sae.forward_bytes(b, d, h, k) == 116_407_296
    least = 78_114_717_696 / 989e12  # the tensor cores' FLOPs bound it
    assert sae.forward_least_s(b, d, h, k) == pytest.approx(least, rel=1e-12)
    assert 116_407_296 / 3.35e12 < least and 100_663_296 / 67e12 < least


def test_sae_step_model_flops():
    # encode 77,309,411,328 + 6*32768*32*384 = 2,415,919,104: ~79.7 GFLOP a step
    assert sae.step_model_flops(32768, 384, 3072, 32) == 79_725_330_432
    # whisper-large 32x at 8192: 2*8192*1280*40960 + 6*8192*32*1280
    assert sae.step_model_flops(8192, 1280, 40960, 32) == 858_993_459_200 + 2_013_265_920


def test_least_s_takes_the_longer_bound():
    assert peaks.least_s(989e12, 0, 1.0) == pytest.approx(1.0)
    assert peaks.least_s(0, 67e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_s(1.0, 0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(989e12, 67e12, 3.35e12) == pytest.approx(1.0)  # side by side


TINY = whisper.Geometry(d=384, ffn=1536, heads=6, enc_layers=4, dec_layers=4, n_mels=80,
                        t_mel=3000)


def test_whisper_tiny_encoder_flops_a_clip():
    # stem: 2*3000*3*80*384 = 552,960,000 and 2*1500*3*384*384 = 1,327,104,000
    # a layer: qkv 1,327,104,000 + scores and sum 3,456,000,000 + out 442,368,000
    #          + fc1 and fc2 3,538,944,000 = 8,764,416,000
    assert whisper.encoder_flops(1, TINY) == 1_880_064_000 + 4 * 8_764_416_000
    assert whisper.encoder_flops(64, TINY) == 64 * 36_937_728_000
    assert whisper.encoder_alu_ops(1, TINY) == 4 * 6 * 1500 * 1500


def test_whisper_tiny_decoder_token_a_clip():
    # a layer: self q/k/v/out 1,179,648 + its core 1,536 + cross q/out 589,824
    # + cross K/V 884,736,000 + cross core 2,304,000 + MLP 2,359,296 = 891,170,304
    assert whisper.decoder_token_flops(1, TINY) == 4 * 891_170_304
    assert whisper.extract_model_flops(2, TINY) == 2 * (36_937_728_000 + 3_564_681_216)


def test_whisper_large_v3_cross_kv_and_total():
    g = whisper.Geometry(d=1280, ffn=5120, heads=20, enc_layers=32, dec_layers=32,
                         n_mels=128, t_mel=3000)
    cross_kv = 32 * 2 * 2 * 1500 * 1280 * 1280
    assert cross_kv == 314_572_800_000  # the ~315 GFLOP a clip of the decoder's K/V
    assert whisper.decoder_token_flops(1, g) > cross_kv
    assert 2.55e12 < whisper.extract_model_flops(1, g) < 2.65e12


def test_whisper_encoder_bytes():
    g = whisper.Geometry(d=128, ffn=256, heads=2, enc_layers=1, dec_layers=1, n_mels=16,
                         t_mel=64)
    # weights: stem 3*16*128 + 128 + 3*128*128 + 128 + 32*128 = 59,648; a layer
    # 4*128^2 + 3*128 + 2*128*256 + 256 + 128 + 4*128 = 132,352; final LN 256
    weights = 59_648 + 132_352 + 256
    # mels 2*16*64 and one layer's capture 2*32*128, both bf16
    assert whisper.encoder_bytes(2, g) == 2 * (weights + 2 * 16 * 64 + 2 * 32 * 128)


def test_geometry_from_a_config():
    cfg = {"d_model": 384, "encoder_ffn_dim": 1536, "encoder_attention_heads": 6,
           "encoder_layers": 4, "decoder_layers": 4, "num_mel_bins": 80}
    assert whisper.Geometry.of(cfg, 3000) == TINY
    assert TINY.t == 1500
