"""The window's arithmetic on a handmade step log."""
import statistics

import pytest

from hbm_bench.window import RequestLog, account, percentile


def _log(stall_at=None, stall=0.0, steps=40, step_s=0.02):
    """Two requests of an 8-token prompt (chunk 8: one prefill step) and
    20 output tokens, admitted at steps 0 and 5; every step takes
    ``step_s`` except ``stall_at``, which takes ``step_s + stall``."""
    ends, t = {}, 0.0
    for s in range(steps):
        t += step_s + (stall if s == stall_at else 0.0)
        ends[s] = t
    reqs = [RequestLog(rid=0, plen=8, olen=20, submit_t=0.0, chunk=8,
                       admit_step=0),
            RequestLog(rid=1, plen=8, olen=20, submit_t=0.1, chunk=8,
                       admit_step=5)]
    return reqs, ends


def test_percentile_is_linear_between_order_statistics():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == pytest.approx(4.8)
    assert percentile(xs, 100) == 5.0
    assert percentile([7.0], 95) == 7.0


def test_tokens_gaps_and_first_tokens_of_the_window():
    reqs, ends = _log()
    acc = account(reqs, ends, first=0, last=39, t0=0.0)
    assert acc.output_tokens == 40
    assert len(acc.itl_s) == 38
    assert all(g == pytest.approx(0.02) for g in acc.itl_s)
    assert acc.ttft_s == [pytest.approx(0.02), pytest.approx(0.12 - 0.1)]
    assert acc.seconds == pytest.approx(0.8)
    # a window that opens late keeps only what falls inside it
    late = account(reqs, ends, first=10, last=39, t0=ends[9])
    assert late.output_tokens == 10 + 15 and not late.ttft_s


def test_a_stall_inside_the_window_moves_rate_and_tail():
    reqs, ends = _log()
    base = account(reqs, ends, first=0, last=39, t0=0.0)
    reqs, ends = _log(stall_at=10, stall=0.5)
    slow = account(reqs, ends, first=0, last=39, t0=0.0)
    rate = lambda a: a.output_tokens / a.seconds           # noqa: E731
    assert rate(slow) < rate(base)
    assert percentile(slow.itl_s, 100) == pytest.approx(0.52)
    assert percentile(slow.itl_s, 95) > percentile(base.itl_s, 95)
    assert statistics.median(slow.itl_s) == pytest.approx(0.02)


def test_chunked_prefill_sets_the_first_token_step():
    r = RequestLog(rid=0, plen=1025, olen=3, submit_t=0.0, chunk=512,
                   admit_step=7)
    assert r.prefill_steps() == 3
    assert [r.token_step(k) for k in range(3)] == [9, 10, 11]
    acc = account([r], {s: float(s) for s in range(20)}, 0, 19, 0.0)
    assert acc.prefill[7] == [(0, 512)] and acc.prefill[9] == [(1024, 1)]
    assert acc.decode_ctx[10] == [1026] and acc.tokens[9] == 1


def test_k4_roofline_leaves_out_a_step_whose_launches_the_trace_splits():
    """A decode step whose K4 launches the trace shows as another count
    than one a layer is left out of both sums; no complete step, no
    reading."""
    from types import SimpleNamespace

    from hbm_bench import peaks
    from hbm_bench.metrics import read
    from hbm_bench.tests.twins import yi_twin
    cfg = yi_twin()
    layers = cfg["num_hidden_layers"]
    spans = [(0.0, 100.0, "decode"), (100.0, 200.0, "decode"),
             (200.0, 300.0, "mixed")]
    counts = [layers, layers - 1, 0]
    ops = [("paged_decode_kernel<2>", a + 1.0 + i, 1e-3)
           for (a, _, _), n in zip(spans, counts) for i in range(n)]
    steps = [SimpleNamespace(index=7 + j, kind=k)
             for j, (_, _, k) in enumerate(spans)]
    run = SimpleNamespace(
        cfg=cfg, steps=steps, decode_ctx=lambda i: [40, 50],
        stretch={"steps": [7, 8, 9], "step_spans": spans, "ops": ops})
    want = 100.0 * layers * peaks.k4_launch_bound_s(cfg, [40, 50]) / (
        layers * 1e-3)
    assert read("k4_roofline", run) == pytest.approx(want)
    run.stretch["ops"] = [o for o in ops if o[1] >= 100.0]
    assert read("k4_roofline", run) is None
