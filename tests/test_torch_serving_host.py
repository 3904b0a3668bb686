"""The host half of the serving path in the PyTorch port against the JAX
package: the options of ``ServeConfig`` that steer the host (the adaptive
controller, the remote registry's routing, policy packing, admission
control, observability, the response cache and the gate's supervisor),
each served end to end through both packages' ``ServeConfig.build`` with
the shared ``world`` of ``tests/test_torch_serving.py`` (a carried
surrogate, a reduced yi-6b remote tier, 64 requests in windows of 16).

Every response (uid, prediction, source, disposition, backend, cost) and
every billing field must be equal. As there, each test first asserts that
no confidence its decisions read lies within 1e-4 of a threshold, so a
failure names the inputs rather than the port. ``latency-ema`` routing
is left out: it reads the wall clock.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.engine import BILLING_FIELDS  # noqa: E402
from repro_torch.core.supervisors import SOFTMAX_SUPERVISORS  # noqa: E402
from repro_torch.serving import RemoteSpec  # noqa: E402
from tests.test_torch_serving import (FIELDS, N_REQ, assert_gapped,  # noqa: E402,F401
                                      gap_cut, serve_both, world)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' operations are too small to gain from torch's
    threads; one keeps them from contending with the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thresholds(world) -> dict:
    t_local = gap_cut(world["local_conf"])
    t_remote = gap_cut(world["remote_conf"])
    assert_gapped(world["local_conf"], t_local, "local conf vs t_local")
    assert_gapped(world["remote_conf"], t_remote, "remote conf vs t_remote")
    return {"t_local": t_local, "t_remote": t_remote}


def assert_same(out, fields=FIELDS) -> tuple:
    (jr, js), (tr, ts) = out
    assert len(jr) == len(tr) == N_REQ
    for a, b in zip(jr, tr):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields], a.uid
    for f in BILLING_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f
    assert set(js.per_backend) == set(ts.per_backend)
    for name, use in js.per_backend.items():
        assert vars(use) == vars(ts.per_backend[name]), name
    return js, ts


@pytest.mark.parametrize("mode", ["fraction", "cost_budget"])
def test_adaptive_controller_matches_jax(world, mode):
    """The online controller in fraction mode (a 0.3 escalation budget)
    and in cost-budget mode ($ per request)."""
    over = {**thresholds(world), "adaptive": True, "control_window": 32,
            "remote_fraction_budget": 0.3}
    if mode == "cost_budget":
        over["cost_budget"] = 0.004
    js, ts = assert_same(serve_both(world, over))
    assert 0 < ts.escalations < N_REQ


@pytest.mark.parametrize("policy", ["primary-failover", "cheapest-available",
                                    "weighted"])
def test_two_remotes_under_each_routing_policy_match_jax(world, policy):
    """Two named backends of different price and latency behind one
    router: each window goes to the backend the policy picks, and each is
    billed apart."""
    remotes = (RemoteSpec("big", cost_per_request=0.004, latency_s=0.2),
               RemoteSpec("small", cost_per_request=0.001, latency_s=0.1))
    js, ts = assert_same(serve_both(
        world, {**thresholds(world), "remotes": remotes,
                "route_policy": policy}))
    assert set(ts.per_backend) <= {"big", "small"}
    assert ts.escalations > 0


def test_policy_packing_matches_jax(world):
    js, ts = assert_same(serve_both(world, {**thresholds(world),
                                            "packing": "policy"}))
    assert ts.escalations > 0


def test_admission_limit_matches_jax(world):
    """Overload admission control: past 24 queued requests the scheduler
    sheds or degrades, alike in both packages; every request is answered
    (the shed ones by the scheduler, outside the engine's count)."""
    js, ts = assert_same(serve_both(
        world, {**thresholds(world), "admission_limit": 24,
                "admission_soft_ratio": 0.25}))
    assert js.requests == ts.requests < N_REQ


def test_observability_on_matches_jax(world):
    """Metrics, traces and the event log on: the same answers and bills."""
    js, ts = assert_same(serve_both(world, {**thresholds(world),
                                            "observability": True}))
    assert ts.escalations > 0


def test_no_response_cache_matches_jax(world):
    """``cache_size=0``: no response cache, every escalation a remote
    call."""
    js, ts = assert_same(serve_both(world, {**thresholds(world),
                                            "cache_size": 0}))
    assert ts.cache_hits == js.cache_hits == 0
    assert ts.remote_calls == ts.escalations > 0


def test_neg_entropy_gate_matches_jax(world):
    """The 1st and 2nd supervisors as the negative entropy of the
    softmax, with thresholds cut in its gaps."""
    score = SOFTMAX_SUPERVISORS["neg_entropy"]
    with torch.no_grad():
        local = score(world["tlocal"](
            torch.from_numpy(world["local_toks"]))).numpy()
        remote = score(world["tremote"](
            {"tokens": world["toks"], "idx": np.arange(N_REQ)})).numpy()
    t_local, t_remote = gap_cut(local), gap_cut(remote)
    assert_gapped(local, t_local, "local neg-entropy vs t_local")
    assert_gapped(remote, t_remote, "remote neg-entropy vs t_remote")
    js, ts = assert_same(serve_both(
        world, {"supervisor": "neg_entropy", "t_local": t_local,
                "t_remote": t_remote}))
    assert 0 < ts.escalations < N_REQ
