"""The plain reference against the program's own pieces at tiny widths,
on the CPU: the decoder's logits, the surrogate, the gate, the
supervisors' reductions and the threshold fit."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from cascade_bench.reference import dense, supervisors, surrogate
from cascade_bench.stack import model_config
from cascade_bench.tests.conftest import TINY
from cascade_bench.traffic import weights


@pytest.mark.parametrize("bias", [False, True])
def test_decoder_matches_the_port_prefill_in_fp32(bias):
    from repro_torch.models import transformer as T
    cfg = {**copy.deepcopy(TINY), "torch_dtype": "float32", "qkv_bias": bias}
    params = weights.draw(cfg, 3, "cpu")
    toks = torch.randint(1, 512, (3, 24), generator=torch.Generator()
                         .manual_seed(0))
    want, _ = T.prefill(model_config(cfg), params, {"tokens": toks})
    got = dense.logits(cfg, params, toks, [23])[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_decoder_logits_at_every_position_match_decode_through_cache():
    from repro_torch.models import transformer as T
    cfg = {**copy.deepcopy(TINY), "torch_dtype": "float32"}
    params = weights.draw(cfg, 4, "cpu")
    mcfg = model_config(cfg)
    toks = torch.randint(1, 512, (2, 10), generator=torch.Generator()
                         .manual_seed(1))
    ref = dense.logits(cfg, params, toks, range(6, 10))
    _, pcache = T.prefill(mcfg, params, {"tokens": toks[:, :6]})
    from repro_torch.serving.generate import graft
    cache = graft(T.make_cache(mcfg, 2, 10, device="cpu"), pcache)
    for i, pos in enumerate(range(6, 9)):
        got, cache = T.decode_step(mcfg, params, toks[:, pos], cache, pos)
        torch.testing.assert_close(got, ref[:, i], rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_from_fp32():
    cfg = {**copy.deepcopy(TINY), "torch_dtype": "float32"}
    params = weights.draw(cfg, 5, "cpu")
    toks = torch.randint(1, 512, (2, 16))
    a = dense.logits(cfg, params, toks, [15])
    b = dense.logits(cfg, params, toks, [15], prec="fp8")
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 1.0


def test_surrogate_matches_the_port_surrogate():
    from repro_torch.models import surrogate as S
    spec = {"vocab": 64, "max_len": 16, "d_model": 32, "num_heads": 2,
            "d_ff": 32, "num_classes": 3}
    params = surrogate.init(spec, torch.Generator().manual_seed(2))
    toks = torch.randint(0, 64, (5, 16), generator=torch.Generator()
                         .manual_seed(3))
    scfg = S.SurrogateConfig("t", vocab_size=64, max_len=16, d_model=32,
                             num_heads=2, d_ff=32, num_classes=3,
                             dropout=0.0)
    torch.testing.assert_close(surrogate.logits(spec, params, toks),
                               S.apply(scfg, params, toks),
                               rtol=1e-5, atol=1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 3 * 2 ** -11])
    assert surrogate.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9]


def test_trainer_lowers_the_loss():
    spec = {"vocab": 64, "max_len": 8, "d_model": 16, "num_heads": 2,
            "d_ff": 16, "num_classes": 2, "train_steps": 30, "lr": 0.01}
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, 64, (64, 8), generator=g)
    labels = (toks[:, 0] % 2).long()
    loss = torch.nn.functional.cross_entropy
    before = loss(surrogate.logits(spec, surrogate.init(
        spec, torch.Generator().manual_seed(9)), toks), labels)
    after = loss(surrogate.logits(spec, surrogate.train(spec, toks, labels,
                                                        9), toks), labels)
    assert after < before


@pytest.mark.parametrize("t_local", [None, 0.6])
@pytest.mark.parametrize("real", [8, 5])
def test_escalations_match_the_port_gate(t_local, real):
    from repro_torch.kernels.confidence_gate.ref import confidence_gate_ref
    logits = torch.randn(8, 3, generator=torch.Generator().manual_seed(4))
    cap = supervisors.capacity(8, 0.3)
    port = confidence_gate_ref(logits, t_local, real, k=cap)
    conf = supervisors.max_softmax(logits)
    torch.testing.assert_close(conf, port["conf"])
    want = [int(i) for i in port["idx"] if i >= 0]
    assert supervisors.escalations(conf.numpy(), real, cap,
                                   t_local).tolist() == want


def test_capacity_matches_the_port():
    from repro_torch.core.cascade import escalation_capacity
    for b, rho in ((32, 0.3), (8, 0.3), (32, 0.05), (4, 1.0)):
        assert supervisors.capacity(b, rho) == escalation_capacity(b, rho)


def test_seq_min_likelihood_and_threshold_match_the_port():
    from repro_torch.core.supervisors import seq_min_likelihood
    from repro_torch.core.thresholds import nominal_quantile_threshold
    lk = torch.rand(6, 5, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(supervisors.seq_min_likelihood(lk),
                               seq_min_likelihood(lk))
    conf = np.random.default_rng(0).random(100)
    for rate in (0.0, 0.05, 0.5):
        assert supervisors.nominal_quantile_threshold(conf, rate) == \
            nominal_quantile_threshold(conf, rate)
