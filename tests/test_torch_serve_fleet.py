"""The serving entry point's fleet shapes against the JAX package's:
``repro_torch.launch.serve --device cpu --smoke`` with the N-tier ladder
(``--set "tiers=edge:0.001:0.1:0.6;cloud:0.0048:0.8"``) and with the
replica cluster (``--set replicas=2 --adaptive``) routes and bills as
``repro.launch.serve`` does on the same flags.

Both launchers draw their own weights, so the port's are carried over
from JAX's: the surrogate JAX's ``train_surrogate`` trains on the task
(deterministic on the CPU) and the reduced yi-6b drawn from
``PRNGKey(7)``, through ``params_from_jax``. The report lines that
carry routing and billing are compared as printed; wall times, and the
cluster's per-replica targets (which depend on when a wall-clock
reconcile falls due), are left out. The cluster run serves its requests
in one flush (batch 32 x 2 replicas), so no reconcile can land between
its windows.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import make_classification_task  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import surrogate as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TIERS = "tiers=edge:0.001:0.1:0.6;cloud:0.0048:0.8"

# report lines that carry routing and billing, and the wall-clock parts
# stripped from them before comparing
KEEP = ("[serve] routing:", "[serve] dispositions:",
        "[serve] accepted accuracy:", "[serve] remote fraction:",
        "[serve] modelled cost:", "[serve] modelled mean latency:",
        "[serve] tier ladder:", "[serve] remote registry:",
        "[serve] router:", "[serve]   edge:", "[serve]   remote:",
        "[serve] cache:", "[serve]   r0:", "[serve]   r1:",
        "[serve] cluster billing:", "[serve] shared cache:",
        "[serve] cluster: 2 replicas")
WALL = (re.compile(r"p95 remote [^;]*;"), re.compile(r" \(target [^)]*\)"))


def report(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        if line.startswith(KEEP):
            for pat in WALL:
                line = pat.sub("", line)
            out.append(line)
    return out


@pytest.fixture(scope="module")
def carried():
    """The weights JAX's launcher makes under ``--smoke``."""
    vocab, seq, ncls = 512, 48, 8
    toks, labels, _ = make_classification_task(
        1, n=512, vocab=vocab, seq_len=seq, num_classes=ncls)
    scfg = jS.SurrogateConfig("local", vocab_size=vocab // 4,
                              max_len=seq // 2, d_model=32, num_heads=2,
                              d_ff=32, num_classes=ncls, dropout=0.0)
    local_toks = (toks[:, : seq // 2] % (vocab // 4)).astype(np.int32)
    sp, sloss = jserve.train_surrogate(scfg, jnp.asarray(local_toks[:512]),
                                       jnp.asarray(labels[:512]))
    rp = jT.init_params(jax_get_config("yi-6b").reduced(),
                        jax.random.PRNGKey(7))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (params_from_jax(to_np(sp), "cpu"), sloss,
            params_from_jax(to_np(rp), "cpu"))


def serve_both(carried, monkeypatch, capsys, flags):
    """Both launchers on the same flags, with the transport's window
    deadline far above JAX's compile of a new window shape (which on a
    loaded host outlasts the default 2 s and would retry the window in
    one package only)."""
    flags = flags + ["--set", "transport.timeout_s=300"]
    sparams, sloss, rparams = carried
    assert jserve.main(["--smoke"] + flags) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(serve, "train_surrogate",
                        lambda *a, **k: (sparams, sloss))
    monkeypatch.setattr(serve.T, "init_params", lambda cfg, gen: rparams)
    assert serve.main(["--device", "cpu", "--smoke"] + flags) == 0
    got = capsys.readouterr().out
    return report(want), report(got)


def test_tier_ladder_entry_point_matches_jax(carried, monkeypatch, capsys):
    want, got = serve_both(carried, monkeypatch, capsys,
                           ["--requests", "64", "--batch", "16",
                            "--set", TIERS])
    assert got == want
    assert any("tier ladder: edge(t=0.6) -> cloud(t=0)" in ln for ln in got)
    assert any("REMOTE" in ln for ln in got if "dispositions" in ln)


def test_replica_cluster_entry_point_matches_jax(carried, monkeypatch,
                                                 capsys):
    want, got = serve_both(carried, monkeypatch, capsys,
                           ["--requests", "64", "--batch", "32",
                            "--set", "replicas=2", "--adaptive"])
    assert got == want
    assert any(ln.startswith("[serve] cluster billing: 64 requests")
               for ln in got)
    assert any(ln.startswith("[serve]   r1: 32 requests") for ln in got)


def test_cluster_refuses_per_replica_tracing(capsys):
    for flags in (["--trace", "t.jsonl"], ["--trace-chrome", "t.json"]):
        with pytest.raises(SystemExit) as e:
            serve.parse_args(["--device", "cpu", "--smoke", "--set",
                              "replicas=2", "--adaptive"] + flags)
        assert e.value.code != 0
        assert "replicas>1" in capsys.readouterr().err
