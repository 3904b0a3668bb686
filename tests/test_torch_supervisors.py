"""The supervisors, metrics and TriSupervised cascade of the PyTorch port
against the JAX package: the sampling family, MDSA (with a carried
``MDSAState`` and with each package's own ``fit_mdsa``), the MDSA
distance's plain version against JAX's oracle and its Pallas kernel in
interpret mode, the autoencoder, ``equivalent_token_confidence``, the
metrics of ``core/metrics.py`` and ``trisupervised_batch`` /
``select_for_labeling``. Inputs come from numpy seeds; the port runs on
the CPU (the MDSA kernel's plain version).

Tolerances: f32 elementwise supervisors 1e-6 (one or two f32 roundings
apart); MDSA distances with a carried state rtol 1e-5 (a quadratic form
of D <= 200 f32 products summed in another order), against the Pallas
kernel rtol/atol 2e-4 (the JAX package's own tolerance for it); each
package's own ``fit_mdsa``: means 1e-6, confidences rtol 1e-4 (f32
covariances and inverses computed by different LAPACK paths, on
well-conditioned activations); autoencoder 1e-6; metrics exact or 1e-12
(the same float64 numpy code); integer outputs (sources, indices,
counts) exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cascade as jcascade  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import supervisors as jsup  # noqa: E402
from repro.kernels.mdsa.ops import mdsa_distance as jax_mdsa  # noqa: E402
from repro.kernels.mdsa.ref import mdsa_ref as jax_mdsa_ref  # noqa: E402
from repro_torch.core import cascade  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import supervisors as sup  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.mdsa import kernel as mk  # noqa: E402
from repro_torch.kernels.mdsa.ops import mdsa_distance  # noqa: E402
from repro_torch.kernels.mdsa.ref import mdsa_ref  # noqa: E402



def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- sampling

@pytest.mark.parametrize("name", sorted(jsup.SAMPLING_SUPERVISORS))
def test_sampling_supervisors_match(name):
    x = rnd(1, (8, 32, 7), 3.0)
    got = sup.SAMPLING_SUPERVISORS[name](t_(x)).numpy()
    want = np.asarray(jsup.SAMPLING_SUPERVISORS[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sampling_supervisors_keys_match():
    assert set(sup.SAMPLING_SUPERVISORS) == set(jsup.SAMPLING_SUPERVISORS)


def test_variation_ratio_unanimous_vs_split():
    unanimous = torch.tensor([[[9.0, 0, 0, 0]]]).repeat(6, 1, 1)
    assert float(sup.variation_ratio(unanimous)[0]) == 1.0
    split = torch.stack([torch.tensor([[9.0, 0, 0, 0]])] * 3
                        + [torch.tensor([[0, 9.0, 0, 0]])] * 3)
    assert float(sup.variation_ratio(split)[0]) == 0.5


def test_mutual_information_zero_when_samples_agree():
    samples = t_(rnd(2, (4, 5), 3.0))[None].repeat(8, 1, 1)
    np.testing.assert_allclose(-sup.mutual_information(samples).numpy(), 0.0,
                               atol=1e-5)


def test_equivalent_token_confidence_matches():
    logits = rnd(3, (6, 40), 2.0)
    groups = (np.random.default_rng(4).uniform(size=(3, 40)) > 0.7).astype(
        np.float32)
    got = sup.equivalent_token_confidence(t_(logits), t_(groups)).numpy()
    want = np.asarray(jsup.equivalent_token_confidence(jnp.asarray(logits),
                                                       jnp.asarray(groups)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- MDSA

MDSA_SHAPES = [(8, 64), (128, 128), (100, 200), (1, 32)]


def spd_inputs(b, d, seed=0):
    x, mean = rnd(seed, (b, d)), rnd(seed + 1, (d,))
    a = rnd(seed + 2, (d, d), 0.3)
    prec = (a @ a.T + np.eye(d, dtype=np.float32)).astype(np.float32)
    return x, mean, prec


@pytest.mark.parametrize("b,d", MDSA_SHAPES)
def test_mdsa_ref_matches_jax_oracle(b, d):
    arrs = spd_inputs(b, d)
    got = mdsa_ref(*map(t_, arrs)).numpy()
    want = np.asarray(jax_mdsa_ref(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,d", MDSA_SHAPES)
def test_mdsa_ref_matches_pallas_kernel(b, d):
    arrs = spd_inputs(b, d, seed=5)
    got = mdsa_distance(*map(t_, arrs)).numpy()
    want = np.asarray(jax_mdsa(*map(jnp.asarray, arrs), force_pallas=True,
                               interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# The CUDA kernel's arithmetic (csrc/mdsa.cu), emulated on the CPU: Z = Y
# P^T in 3xTF32 (each operand split into big = tf32(v), rounded to
# nearest with ties away as cvt.rna rounds, and small = v - big truncated
# to TF32; small.big + big.small + big.big, fp32 sums of exact products),
# each depth slice's Z folded per column tile into a partial row sum, the
# partials summed in the kernel's fixed order.

def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits) by bits, round to nearest with
    ties away from zero, as the kernel's integer rounding does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by dropping the low 13 bits (toward zero)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mdsa_3xtf32(x, mean, prec):
    b, d = x.shape
    p = mk.plan(b, d)
    y = x - mean
    yb, pb = tf32_rna(y), tf32_rna(prec)
    ys, ps = tf32_trunc(y - yb), tf32_trunc(prec - pb)
    parts = []
    for s in range(p.splits):
        ks = slice(s * p.slice_len, min(d, (s + 1) * p.slice_len))
        z = (ys[:, ks] @ pb[:, ks].T + yb[:, ks] @ ps[:, ks].T) \
            + yb[:, ks] @ pb[:, ks].T
        for jt in range(p.col_tiles):
            js = slice(jt * mk.COL_TILE, (jt + 1) * mk.COL_TILE)
            parts.append((z[:, js] * y[:, js]).sum(1))
    d2 = torch.zeros(b)
    for part in parts:
        d2 = d2 + part
    return torch.sqrt(torch.clamp(d2, min=0.0))


def mdsa_kernel_inputs(b, d, seed, antisymmetric=False):
    """x normal, mean 0.3 normal, P = A A^T 0.09 / D + I as the chip check
    draws it; ``antisymmetric`` adds C - C^T of P's Frobenius norm."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d), np.float32)
    prec = (a @ a.T * (0.09 / d) + np.eye(d, dtype=np.float32))
    if antisymmetric:
        c = rng.standard_normal((d, d), np.float32)
        prec = prec + (c - c.T) * (np.linalg.norm(prec)
                                   / np.linalg.norm(c - c.T))
    x = rng.standard_normal((b, d), np.float32)
    mean = 0.3 * rng.standard_normal(d).astype(np.float32)
    return x, mean, prec.astype(np.float32)


@pytest.mark.parametrize("b,d,anti", [(256, 1024, False), (1024, 64, False),
                                      (100, 200, False), (256, 1024, True),
                                      (33, 61, True)])
def test_mdsa_kernel_3xtf32_arithmetic_matches_jax(b, d, anti):
    """The kernel's 3xTF32 Y P^T form (emulated) against JAX's oracle
    within the MDSA tolerance 1e-4, for P symmetric or not; it keeps
    fp32 accuracy, using under a tenth of that limit."""
    arrs = mdsa_kernel_inputs(b, d, seed=b + d, antisymmetric=anti)
    got = mdsa_3xtf32(*map(t_, arrs)).numpy()
    want = np.asarray(jax_mdsa_ref(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.max(np.abs(got - want) / (1e-4 * np.abs(want) + 1e-4)) < 0.1


@pytest.mark.parametrize("b,d", [(1, 1), (1, 7), (33, 61), (100, 200),
                                 (1024, 64), (128, 257), (64, 260),
                                 (256, 4096), (129, 4100), (5000, 3)])
def test_mdsa_plan_covers_every_row_column_and_depth_once(b, d):
    """The kernel's blocks are the product of row tiles, column tiles and
    depth slices; each axis is cut into non-empty ranges that cover it
    exactly once, so every (row, column, depth) of [B, D] x [D, D] is
    one block's. Slices are whole pipeline steps and fill the card."""
    p = mk.plan(b, d)
    assert mk.plan(b, d) is p                   # cached per shape
    for n, tile, count in ((b, mk.ROW_TILE, p.row_tiles),
                           (d, mk.COL_TILE, p.col_tiles),
                           (d, p.slice_len, p.splits)):
        cover = np.zeros(n, int)
        for i in range(count):
            lo, hi = i * tile, min(n, (i + 1) * tile)
            assert lo < hi
            cover[lo:hi] += 1
        assert (cover == 1).all()
    assert p.slice_len % mk.DEPTH_STEP == 0
    assert p.parts == p.splits * p.col_tiles
    blocks = p.row_tiles * p.col_tiles * p.splits
    assert p.splits == 1 or blocks <= mk.SM_COUNT * mk.RESIDENT


def test_mdsa_cpu_tensors_never_count_a_launch():
    before = launch_counts()["mdsa"]
    mdsa_distance(*map(t_, spd_inputs(4, 16)))
    assert launch_counts()["mdsa"] == before


def test_mdsa_confidence_with_carried_state():
    train = rnd(6, (512, 24))
    st = jsup.fit_mdsa(jnp.asarray(train))
    tst = sup.MDSAState(mean=t_(st.mean), prec=t_(st.prec))
    x = rnd(7, (64, 24), 1.5)
    got = sup.mdsa_confidence(tst, t_(x)).numpy()
    want = np.asarray(jsup.mdsa_confidence(st, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got <= 0).all()


def test_fit_mdsa_matches_jax():
    train = rnd(8, (512, 24)) * np.linspace(0.5, 2.0, 24, dtype=np.float32)
    st, jst = sup.fit_mdsa(t_(train)), jsup.fit_mdsa(jnp.asarray(train))
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(jst.mean),
                               atol=1e-6)
    assert st.prec.dtype == torch.float32 and st.prec.is_contiguous()
    x = rnd(9, (64, 24), 1.5)
    np.testing.assert_allclose(
        sup.mdsa_confidence(st, t_(x)).numpy(),
        np.asarray(jsup.mdsa_confidence(jst, jnp.asarray(x))), rtol=1e-4)


def test_mdsa_flags_outliers():
    x = t_(rnd(10, (512, 16)))
    st = sup.fit_mdsa(x)
    nominal = sup.mdsa_confidence(st, x[:100])
    outlier = sup.mdsa_confidence(st, x[:100] + 8.0)
    assert float(nominal.mean()) > float(outlier.mean())


def test_mdsa_is_scale_aware():
    """Mahalanobis (not Euclidean): deviation along a high-variance axis is
    less surprising than the same deviation along a low-variance axis."""
    x = t_(rnd(11, (4096, 2))) * torch.tensor([10.0, 0.1])
    st = sup.fit_mdsa(x)
    hi_var = sup.mdsa_confidence(st, torch.tensor([[5.0, 0.0]]))
    lo_var = sup.mdsa_confidence(st, torch.tensor([[0.0, 5.0]]))
    assert float(hi_var[0]) > float(lo_var[0])


# ------------------------------------------------------------ autoencoder

def test_autoencoder_confidence_with_carried_params():
    d, lat = 16, 4
    params = {"enc": rnd(12, (d, lat), 0.3), "enc_b": rnd(13, (lat,), 0.1),
              "dec": rnd(14, (lat, d), 0.3), "dec_b": rnd(15, (d,), 0.1)}
    x = rnd(16, (32, d))
    got = sup.autoencoder_confidence({k: t_(v) for k, v in params.items()},
                                     t_(x)).numpy()
    want = np.asarray(jsup.autoencoder_confidence(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fit_autoencoder_separates_on_and_off_manifold():
    """Mirrors tests/test_supervisors.py: nominal data on a 2-D manifold
    in 16-D reconstructs better than off-manifold noise."""
    basis = t_(rnd(17, (2, 16)))
    nominal = t_(rnd(18, (256, 2))) @ basis
    params = sup.fit_autoencoder(torch.Generator().manual_seed(0), nominal,
                                 latent=4, steps=300)
    assert set(params) == {"enc", "enc_b", "dec", "dec_b"}
    assert not any(p.requires_grad for p in params.values())
    on = sup.autoencoder_confidence(params, nominal[:64])
    off = sup.autoencoder_confidence(params, t_(rnd(19, (64, 16), 3.0)))
    assert float(on.mean()) > float(off.mean())


def test_fit_autoencoder_lowers_the_reconstruction_error():
    """From the same initial weights (one generator seed), 100 steps
    reconstruct the data better than none."""
    x = t_(rnd(20, (128, 8)))
    p0 = sup.fit_autoencoder(torch.Generator().manual_seed(1), x, latent=4,
                             steps=0)
    p1 = sup.fit_autoencoder(torch.Generator().manual_seed(1), x, latent=4,
                             steps=100)
    assert float(sup.autoencoder_confidence(p1, x).mean()) > \
        float(sup.autoencoder_confidence(p0, x).mean())


# --------------------------------------------------------------- metrics

def _curve_inputs(seed=21, n=200):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(size=n)
    local_ok = rng.uniform(size=n) < conf
    remote_ok = rng.uniform(size=n) < 0.85
    return conf, local_ok, remote_ok


def test_request_accuracy_curve_and_auc_match():
    conf, lc, rc = _curve_inputs()
    rac = metrics.request_accuracy_curve(conf, lc, rc)
    jrac = jmetrics.request_accuracy_curve(conf, lc, rc)
    np.testing.assert_array_equal(rac.remote_fraction, jrac.remote_fraction)
    np.testing.assert_array_equal(rac.accuracy, jrac.accuracy)
    assert metrics.auc_rac(rac) == jmetrics.auc_rac(jrac)
    assert rac.knee_points() == jrac.knee_points()
    assert (rac.local_only, rac.remote_only) == \
        (jrac.local_only, jrac.remote_only)


@pytest.mark.parametrize("betas", [(0.5, 1.0, 2.0), (1.0,)])
def test_supervised_metrics_match(betas):
    rng = np.random.default_rng(22)
    accepted = rng.uniform(size=300) < 0.7
    correct = rng.uniform(size=300) < 0.8
    assert metrics.supervised_metrics(accepted, correct, betas) == \
        jmetrics.supervised_metrics(accepted, correct, betas)
    none = np.zeros(10, bool)
    assert metrics.supervised_metrics(none, none) == \
        jmetrics.supervised_metrics(none, none)


@pytest.mark.parametrize("fpr", [0.0, 0.05, 0.3])
def test_threshold_for_fpr_matches(fpr):
    conf, correct, _ = _curve_inputs(23)
    assert metrics.threshold_for_fpr(conf, correct, fpr) == \
        jmetrics.threshold_for_fpr(conf, correct, fpr)


# --------------------------------------------------------- TriSupervised

def test_trisupervised_batch_matches_jax():
    rng = np.random.default_rng(24)
    n = 64
    preds = [rng.integers(0, 5, n).astype(np.int32) for _ in range(3)]
    confs = [rng.uniform(size=n).astype(np.float32) for _ in range(3)]
    th, jth = (cascade.TriThresholds(0.6, 0.5, 0.4),
               jcascade.TriThresholds(0.6, 0.5, 0.4))
    args = [a for pc in zip(preds, confs) for a in pc]
    got = cascade.trisupervised_batch(*map(t_, args), th)
    want = jcascade.trisupervised_batch(*map(jnp.asarray, args), jth)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    src = got["source"].numpy()
    assert {cascade.LOCAL, cascade.EDGE, cascade.REMOTE,
            cascade.REJECTED} <= set(src.tolist())
    assert cascade.EDGE == jcascade.EDGE


@pytest.mark.parametrize("budget", [1, 7, 32])
def test_select_for_labeling_matches_jax(budget):
    conf = np.random.default_rng(25).uniform(size=32).astype(np.float32)
    idx, mask = cascade.select_for_labeling(t_(conf), budget)
    jidx, jmask = jcascade.select_for_labeling(jnp.asarray(conf), budget)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
