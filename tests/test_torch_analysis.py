"""The port's roofline analysis against the JAX package's.

``param_counts`` and ``model_flops`` are the same arithmetic over the two
packages' parameter trees and must be equal. The port counts dot FLOPs
by tallying the local aten ops of a step run on fake tensors
(``analysis.roofline.OpTally``); JAX reads them from the compiled HLO
(``fp32_dot_flops(compiled.as_text())[1]``). On reduced yi-6b on one
device they must agree within 0.5% for prefill and decode; the remat'd
train step is held within 3%, because the port's chunked cross-entropy
checkpoints each chunk and so recomputes the head product
(2·B·T·D·V) in the backward, which XLA drops as a common subexpression
(measured: 2.3% of the step). MoE configs are left out: the port runs
each expert on the rows routed to it only, where JAX multiplies a
capacity-sized buffer.

``report``'s tables must be string-equal on the same rows, and the fp32
attention-score ablation (``set_scores_fp32``) must give the same
attention in both packages. ``python -m repro_torch.analysis.perf`` runs
in a subprocess (its fake process group is process-global).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import report as jreport  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import scan_config  # noqa: E402
from repro_torch.analysis import report, roofline  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.specs import lower_step  # noqa: E402
from repro_torch.models import layers, mla  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_and_model_flops_are_jax(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    assert roofline.param_counts(cfg) == jroof.param_counts(jcfg)
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            jroof.model_flops(jcfg, JSHAPES[name])


# (kind, relative tolerance): see the module docstring for train's
DOT_CASES = [("prefill", 0.005), ("decode", 0.005), ("train", 0.03)]


@pytest.mark.parametrize("kind,tol", DOT_CASES)
def test_dot_flops_agree_with_jax_hlo(kind, tol):
    jcfg, cfg = jget("yi-6b").reduced(), get_config("yi-6b").reduced()
    with scan_config.unrolled():
        compiled = jspecs.lower_step(jcfg, JShape("s", 64, 2, kind),
                                     jhost_mesh()).compile()
    want = jroof.fp32_dot_flops(compiled.as_text())[1]
    tally = roofline.measure(lower_step(cfg, ShapeConfig("s", 64, 2, kind),
                                        make_host_mesh()))
    assert want > 0
    assert tally.total_dot_flops == pytest.approx(want, rel=tol)
    if kind != "train":
        assert tally.total_dot_flops == want      # exact, as measured


def test_tally_charges_widened_bf16_dots_at_the_bf16_rate():
    """A plain path widens bf16 operands to fp32 for an fp32-accumulated
    product (JAX's ``preferred_element_type``): that dot is charged as
    bf16; a product of genuine fp32 values as fp32; nothing is counted
    on tensors the tally did not see made."""
    from repro_torch.launch.sharding import fake_mode
    with fake_mode():
        a = torch.empty(8, 16, dtype=torch.bfloat16)
        b = torch.empty(16, 4, dtype=torch.bfloat16)
        f = torch.empty(16, 4)
        t = roofline.OpTally()
        with t:
            a.float() @ b.float()                   # widened: bf16
            (a.float() @ f).sum()                   # one genuine fp32
            a @ b                                   # bf16
    assert t.dot_flops == {"bf16": 2 * 2 * 8 * 16 * 4,
                           "fp32": 2 * 8 * 16 * 4}
    assert t.bytes > 0 and t.peak_bytes > 0
    assert roofline.fp32_penalty() == pytest.approx(989 / 67)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_recurrence_charged_per_step_counts_every_step(arch, kind):
    """Fake tensors run two steps of a plain recurrence (``shard_hints
    .stepwise``) and charge their ops, forward and backward, T/2 times:
    the dot FLOPs equal the same step's on real tensors, where all T
    steps run (reduced config, T = 16; only the stand-in's last-step
    repeat differs, and it is no dot). RWKV6's prefill runs its scan
    kernel, which fake tensors count whole as its op (its formula
    credits all T steps), so nothing there is charged per step."""
    from repro_torch.launch.specs import make_steps
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("s", 16, 2, kind)
    fake = roofline.measure(lower_step(cfg, shape, make_host_mesh()))
    assert fake.charged == (kind == "train" or arch == "zamba2-7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))}
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), remat=True)
        args = (params, init_opt_state(params), batch)
    else:
        step, args = make_steps(cfg)[1], (params, batch)
    real = roofline.OpTally()
    with real:
        step(*args)
    assert not real.charged
    assert fake.total_dot_flops == pytest.approx(real.total_dot_flops,
                                                 rel=1e-12)


def test_memory_term_is_the_bytes_a_step_must_move():
    """Reduced yi-6b's decode step: the memory term reads the weights,
    the cache and the token once and writes the logits and one cache
    slot a layer (k and v) once; the op tally's unfused traffic is more
    and is reported beside it."""
    from repro_torch.launch.specs import local_bytes
    cfg = get_config("yi-6b").reduced()
    shape = ShapeConfig("d", 64, 2, "decode")
    lowered = lower_step(cfg, shape, make_host_mesh())
    t = roofline.measure(lowered)
    params, token, cache, _ = lowered.args
    hd = cfg.resolved_head_dim
    slot = 2 * cfg.num_layers * 2 * cfg.num_kv_heads * hd * 4   # fp32
    assert t.written_bytes == slot
    assert t.io_bytes == (local_bytes(params) + local_bytes(cache)
                          + local_bytes(token) + 2 * cfg.vocab_size * 4
                          + slot)
    rec = roofline.roofline_record(t, cfg, shape, make_host_mesh())
    assert rec["bytes_per_chip"] == t.io_bytes
    assert rec["memory_s"] == t.io_bytes / roofline.HBM_BW
    assert rec["unfused_bytes_per_chip"] == t.bytes > t.io_bytes
    assert rec["method"] == "full-depth"


def _rows():
    rf = {"compute_s": 2.5e-3, "memory_s": 4e-4, "collective_s": 1.5,
          "bottleneck": "collective", "model_flops": 1.2e15,
          "useful_ratio": 0.42}
    return [
        {"arch": "yi-6b", "shape": "decode_32k", "mesh": "single",
         "status": "ok", "compile_s": 3.2,
         "memory": {"argument_size_in_bytes": 1831870496},
         "roofline": rf},
        {"arch": "yi-6b", "shape": "train_4k", "mesh": "multi",
         "status": "ok", "compile_s": 20.1,
         "memory": {"argument_size_in_bytes": 123456789012},
         "roofline": dict(rf, compute_s=0.0, memory_s=0.5)},
        {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
         "status": "skip",
         "reason": "encoder-only architecture has no decode step"},
        {"arch": "rwkv6-1.6b", "shape": "train_4k", "mesh": "single",
         "status": "fail", "error": "x"},
        {"arch": "rwkv6-1.6b", "shape": "prefill_32k", "mesh": "single",
         "status": "ok", "compile_s": 1.0, "memory": {},
         "roofline": dict(rf, compute_s=5e-7, memory_s=0.02)},
    ]


def test_report_tables_are_jax():
    rows = _rows()
    assert report.dryrun_table(rows) == jreport.dryrun_table(rows)
    assert report.roofline_table(rows) == jreport.roofline_table(rows)
    assert report.interesting_pairs(rows) == jreport.interesting_pairs(rows)
    for n in (None, 0, 1023, 1 << 20, 3.5e12, 2e16):
        assert report.fmt_bytes(n) == jreport.fmt_bytes(n)
    for x in (0, 5e-7, 2.5e-3, 1.5):
        assert report.fmt_s(x) == jreport.fmt_s(x)


@pytest.fixture
def scores_fp32():
    """Both packages' fp32-score ablation on, and off again after."""
    jlayers.set_scores_fp32(True)
    layers.set_scores_fp32(True)
    try:
        yield
    finally:
        jlayers.set_scores_fp32(False)
        layers.set_scores_fp32(False)


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_fp32_scores_attention_is_jax(scores_fp32):
    """bf16 q/k/v through ``gqa_attention`` on the ablation path: both
    keep the softmax weights fp32 into the PV product, so the outputs
    agree to within one bf16 rounding of the output (2^-8 relative, plus
    1e-3 for fp32 sums in another order); with the ablation off the port
    rounds the weights to bf16 first and moves off that result."""
    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, s) for s in ((2, 24, 8, 64), (2, 24, 2, 64),
                                       (2, 24, 2, 64)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jlayers.gqa_attention(jq, jk, jv, causal=True,
                                            q_offset=0).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = layers.gqa_attention(tq, tk, tv, causal=True).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-3)
    layers.set_scores_fp32(False)
    rounded = layers.gqa_attention(tq, tk, tv, causal=True).float().numpy()
    assert not np.array_equal(rounded, got)


def test_fp32_scores_mla_is_jax(scores_fp32):
    """Reduced deepseek-v2-lite's naive MLA in bf16 on the ablation path,
    JAX's parameters carried: equal within the same tolerance (all its
    dots are fp32 there, in both packages)."""
    jcfg = dataclasses.replace(jget("deepseek-v2-lite-16b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="bfloat16")
    jp = jmla.mla_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    x = _bf16(np.random.default_rng(1), (2, 16, jcfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    want, _ = jmla.mla_forward(jcfg, jp, jx, jnp.arange(16))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got, _ = mla.mla_forward(cfg, tp, torch.from_numpy(x).bfloat16(),
                             torch.arange(16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-3)


def test_perf_entrypoint_runs():
    """``python -m repro_torch.analysis.perf`` on the fake 256-rank mesh,
    with the fp32-score ablation, in a subprocess."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.perf", "--arch",
         "rwkv6-1.6b", "--shape", "decode_32k", "--fp32-scores"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[perf] rwkv6-1.6b x decode_32k" in r.stdout
    assert "-> memory" in r.stdout or "-> compute" in r.stdout \
        or "-> collective" in r.stdout
