"""The yardstick's FLOP and byte counts (the dense family's model FLOPs,
the kernels' bounds) against shapes worked by hand."""

from __future__ import annotations

import pytest

from cascade_bench import flops
from cascade_bench.reference import dense
from cascade_bench.reference.dense import widths
from cascade_bench.spec import model_config

YI = widths(model_config("yi-6b"))
QWEN = widths(model_config("qwen2-7b"))


def test_yi_matrix_parameters_a_token():
    # q, k, v: 4096 x (32 + 2 x 4) x 128; o: 4096 x 4096; SwiGLU 3 x
    # 4096 x 11008; 32 layers: 5.54e9 parameters, 2 FLOPs each
    per_layer = 4096 * 5120 + 4096 * 4096 + 3 * 4096 * 11008
    assert per_layer == 173_015_040
    assert dense.prefill_flops(YI, 1, 1) == pytest.approx(
        2 * 32 * per_layer + 4 * 32 * 32 * 128 * 1 + 2 * 4096 * 64000)


def test_prefill_of_a_review():
    # one 512-token row: 2 x 5.5365e9 x 512 + causal attention
    # 4 x 32 x 32 x 128 x (512 x 513 / 2) + the last position's head
    want = (2 * 5_536_481_280 * 512 + 4 * 32 * 32 * 128 * 131_328
            + 2 * 4096 * 64000)
    assert dense.prefill_flops(YI, 1, 512) == pytest.approx(want)
    assert dense.prefill_flops(YI, 10, 512) == pytest.approx(10 * want)


def test_qwen_prefill_counts_its_widths():
    per_layer = 3584 * (3584 + 2 * 512) + 3584 * 3584 + 3 * 3584 * 18944
    want = (2 * 28 * per_layer * 512 + 4 * 28 * 28 * 128 * 131_328
            + 2 * 3584 * 152064)
    assert dense.prefill_flops(QWEN, 1, 512) == pytest.approx(want)


def test_decode_step_attends_to_every_key_so_far():
    # the token at position 300 reads 301 keys
    step = dense.decode_flops(YI, 2, 300)
    assert step == pytest.approx(2 * (2 * 5_536_481_280
                                      + 4 * 32 * 32 * 128 * 301
                                      + 2 * 4096 * 64000))
    gen = flops.generate_flops(dense, YI, 2, 256, 3)
    assert gen == pytest.approx(dense.prefill_flops(YI, 2, 256)
                                + dense.decode_flops(YI, 2, 256)
                                + dense.decode_flops(YI, 2, 257))


def test_flash_bound_of_a_window_is_its_bytes():
    # [8 x 512], q and o 32 heads, k and v 4 heads, hd 128, bf16:
    # 2 x 8 x 512 x 128 x (64 + 8) = 75.5 MB at 3.35 TB/s = 22.5 us;
    # 4 x 8 x 32 x 128 x 131328 = 17.2 GFLOP at 989 TFLOP/s = 17.4 us
    nbytes = 2 * 8 * 512 * 128 * (2 * 32 + 2 * 4)
    assert nbytes == 75_497_472
    assert flops.flash_bound_s(YI, 8, 512) == pytest.approx(nbytes / 3.35e12)
    fl = 4 * 8 * 32 * 128 * 512 * 513 / 2
    assert fl / 989e12 < nbytes / 3.35e12


def test_decode_attention_bound_reads_the_valid_cache():
    # 256 rows, 300 valid slots of 4 KV heads x 128, bf16, plus q and o
    nbytes = 2 * 256 * 128 * (2 * 32 + 2 * 4 * 300)
    assert flops.decode_attn_bound_s(YI, 256, 300) == pytest.approx(
        nbytes / 3.35e12)


def test_roofline_takes_the_larger_side():
    assert flops.roofline_s(989e12, 0.0) == pytest.approx(1.0)
    assert flops.roofline_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.peak("an unknown card") == flops.peak()
