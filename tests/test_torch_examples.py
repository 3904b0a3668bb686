"""The port's six examples (``repro_torch.examples``), the counterparts of
``examples/*.py``: each ``main`` runs on the CPU at the JAX example's
sizes (``adaptive_cascade`` at an eighth of its requests, the training
example at its smoke scale for 3 steps) and its own assertions pass.
``generate_long_context`` is also held to the JAX package on JAX's
reduced rwkv6 parameters, carried over: the same greedy tokens, and the
per-token likelihoods and both sequence reducers within 1e-5 (f32
softmax of logits summed in another order).
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.supervisors import seq_min_likelihood as jax_min  # noqa: E402
from repro.core.supervisors import seq_prod_likelihood as jax_prod  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serving.generate import greedy_generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

LIK_TOL = 1e-5


def smoke_argv(name: str, tmp_path) -> list[str]:
    return {"adaptive_cascade": ["--scale", "0.125"],
            "train_surrogate": ["--scale", "smoke", "--steps", "3",
                                "--checkpoint",
                                str(tmp_path / "ckpt.msgpack")]}.get(name,
                                                                     [])


EXAMPLES = ("quickstart", "serve_cascade", "adaptive_cascade",
            "observability_demo", "train_surrogate", "generate_long_context")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(["--device", "cpu"] + smoke_argv(name, tmp_path))
    assert isinstance(out, dict) and out
    assert capsys.readouterr().out.strip()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_a_missing_gpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(smoke_argv(name, tmp_path))


def test_train_surrogate_100m_config():
    from repro_torch.examples.train_surrogate import build_cfg
    cfg = build_cfg("100m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.vocab_size, cfg.dtype) == (6, 768, 8, 16384, "float32")
    assert build_cfg("smoke") == get_config("deepseek-v2-lite-16b").reduced()


def test_generate_long_context_matches_jax():
    """The example's generation on JAX's reduced rwkv6 parameters and
    prompt (``examples/generate_long_context.py``: PRNGKey(0), numpy seed
    0, 2 x 48 tokens, 12 new)."""
    from repro_torch.examples.generate_long_context import generate
    jcfg = jax_get_config("rwkv6-1.6b").reduced()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 48)).astype(np.int32)
    jtoks, jliks = jax_generate(jcfg, jp, {"tokens": prompt},
                                max_new_tokens=12)
    got = generate(get_config("rwkv6-1.6b").reduced(),
                   params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                   prompt, 12)
    np.testing.assert_array_equal(got["tokens"], np.asarray(jtoks))
    np.testing.assert_allclose(got["liks"], np.asarray(jliks), rtol=0,
                               atol=LIK_TOL)
    np.testing.assert_allclose(got["conf_min"], np.asarray(jax_min(jliks)),
                               rtol=0, atol=LIK_TOL)
    np.testing.assert_allclose(got["conf_prod"],
                               np.asarray(jax_prod(jliks)), rtol=0,
                               atol=LIK_TOL)
