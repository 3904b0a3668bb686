"""One seed replays the same trace, inputs and weights bit for bit;
another seed orders the same arrivals differently."""

from __future__ import annotations

import numpy as np
import torch

from cascade_bench.tests.conftest import TINY
from cascade_bench.traffic import loadgen, synthetic, weights

SEED = 2 ** 31 + 12345


def _task(seed, n=64, block=0):
    teach = synthetic.teacher(np.random.default_rng([seed, 0]), vocab=500,
                              seq_len=32, num_classes=2)
    return synthetic.examples(np.random.default_rng([seed, 4, block]),
                              teach, n=n, seq_len=32)


def test_task_replays_bit_for_bit():
    a, b = _task(SEED), _task(SEED)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    assert a[0].tobytes() != _task(SEED + 1)[0].tobytes()
    assert a[0].tobytes() != _task(SEED, block=1)[0].tobytes()
    assert a[0].min() >= 1 and a[0].max() < 500
    assert set(np.unique(a[1])) <= {0, 1}


def test_window_rows_replay_alone_in_any_order():
    """A block of window rows is the same whether the run drew the
    blocks before it or not, so the check can draw the rows it judges
    again; the training rows are another stream."""
    from cascade_bench import stack
    from cascade_bench.tests.conftest import tiny_cell
    cell = tiny_cell("yi-6b.reviews512.backlog")
    a = stack.build(cell.config, cell.traffic, SEED, torch.device("cpu"))
    b = stack.build(cell.config, cell.traffic, SEED, torch.device("cpu"))
    try:
        uids = [stack.BLOCK * 3 + 5, 7, stack.BLOCK + 1]
        for i in range(4):
            a.block(i)
        got, want = a.rows(uids), b.rows(uids)
        for x, y in zip(got, want):
            assert x.tobytes() == y.tobytes()
        assert got[0].tobytes() != a.train_toks[:3].tobytes()
        req = b.request(uids[0])
        assert req.remote_input["tokens"].tobytes() == got[0][0].tobytes()
    finally:
        a.close()
        b.close()


def test_local_view_clips_and_folds():
    toks = np.array([[1, 65, 130, 7]], np.int32)
    assert synthetic.local_view(toks, 3, 64).tolist() == [[1, 1, 2]]


def test_arrivals_replay_and_every_seed_gets_the_same_gaps():
    a = loadgen.due_times(np.random.default_rng(SEED), 200.0, 10.0)
    b = loadgen.due_times(np.random.default_rng(SEED), 200.0, 10.0)
    c = loadgen.due_times(np.random.default_rng(SEED + 1), 200.0, 10.0)
    assert a.tobytes() == b.tobytes()
    assert a.size == c.size == 2000
    assert a[-1] == np.float64(a[-1]) and abs(a[-1] - 10.0) < 1e-9
    assert abs(c[-1] - 10.0) < 1e-9
    assert not np.array_equal(a, c)
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(c, prepend=0)))


def test_weights_replay_bit_for_bit_in_the_port_layout():
    a = weights.draw(TINY, SEED, "cpu")
    b = weights.draw(TINY, SEED, "cpu")
    assert a["blocks"]["attn"]["wq"]["w"].shape == (2, 64, 64)
    assert a["blocks"]["attn"]["wk"]["b"].shape == (2, 32)
    assert a["blocks"]["mlp"]["w_down"]["w"].shape == (2, 128, 64)
    assert a["head"]["w"].shape == (64, 512)
    for path in (("embed",), ("blocks", "norm1"), ("head", "w"),
                 ("blocks", "attn", "wv", "b")):
        x, y = a, b
        for k in path:
            x, y = x[k], y[k]
        assert x.dtype == torch.bfloat16
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert float(a["blocks"]["norm1"].float().mean()) > 0.9


def test_open_loop_latency_is_hand_back_less_due_on_the_harness_clock():
    """``cascade_latency_p95_ms`` reads the harness's own stamps: each
    request's hand-back into the scheduler's record, less its due time.
    The program's ``Response.latency_s`` (its clock, from the enqueue
    time the generator gives it) lies just under it."""
    from cascade_bench import loops, stack
    from cascade_bench.tests.conftest import tiny_cell
    from cascade_bench.trace import Tracer
    cell = tiny_cell("yi-6b.reviews512.poisson")
    sut = stack.build(cell.config, cell.traffic, SEED, torch.device("cpu"))
    sut.warm_up()
    win = loops.poisson(sut, 1.0, Tracer(False, 0.0, 0.0, torch.device("cpu"),
                                        stack.now))
    sut.close()
    assert len(win.responses) == win.attempted == len(win.latencies_s)
    for r in win.responses:
        ours = win.latencies_s[r.uid]
        assert ours >= win.lags_s[r.uid]
        assert 0.0 <= ours - r.latency_s < 0.05, (ours, r.latency_s)
    assert not any(np.isinf(win.latencies_s))
