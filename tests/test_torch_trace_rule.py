"""``chip_smoke.py``'s rule for a torch.profiler trace: a trace of ``iters``
calls counts only when it holds ``iters`` times the kernels that a trace of
one call shows; an incomplete trace is taken again, and after three the
run fails. A trace counts only the kernels after its marker kernel. No
card: the script is loaded with importlib, its tracer is replaced by a
stub and the profiler's events by plain objects."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_rule", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stub_tracer(cs, monkeypatch, per_call, traced):
    """Replace ``kernel_trace``: a call launches ``per_call`` kernels, and
    the n-th trace of several calls holds ``traced[n]`` of them (the last
    entry from then on). Returns the list of traced call counts."""
    seen = []

    def kernel_trace(fn, calls):
        for _ in range(calls):
            fn()
        seen.append(calls)
        if calls == 1:
            return per_call, 3.0 * per_call, [("k", per_call, 3.0 * per_call)]
        n = traced[min(sum(c > 1 for c in seen) - 1, len(traced) - 1)]
        return n, 3.0 * n, [("k", n, 3.0 * n)]

    monkeypatch.setattr(cs, "kernel_trace", kernel_trace)
    return seen


@pytest.mark.parametrize("iters, k", [(1, 1), (3, 6), (5, 7), (20, 1), (20, 3)])
def test_accepts_every_kernel(cs, iters, k):
    assert cs.trace_complete(iters * k, iters, k, 1.0)


@pytest.mark.parametrize("missing", [1, 3, "a call", "all"])
def test_refuses_a_trace_that_missed_kernels(cs, missing):
    iters, k = 20, 3
    gone = {"a call": k, "all": iters * k}.get(missing, missing)
    # device time is there all the same: the kernels that were traced ran
    assert not cs.trace_complete(iters * k - gone, iters, k, 41.5)


def test_refuses_extra_kernels_no_device_time_and_an_empty_call(cs):
    assert not cs.trace_complete(61, 20, 3, 1.0)
    assert not cs.trace_complete(60, 20, 3, 0.0)
    assert not cs.trace_complete(0, 20, 0, 0.0)


def test_device_ms_reads_a_complete_trace(cs, monkeypatch):
    calls = []
    seen = stub_tracer(cs, monkeypatch, 2, [40])
    ms = cs.device_ms(lambda: calls.append(1), iters=20, warmup=3)
    assert ms == pytest.approx(3.0 * 40 / 1e3 / 20)
    assert seen == [1, 20] and len(calls) == 3 + 1 + 20


def test_device_ms_takes_an_incomplete_trace_again(cs, monkeypatch):
    seen = stub_tracer(cs, monkeypatch, 2, [37, 39, 40])
    assert cs.device_ms(lambda: None, iters=20) == pytest.approx(3.0 * 40 / 1e3 / 20)
    assert seen == [1, 20] * 3


def test_device_ms_fails_after_three_incomplete_traces(cs, monkeypatch, capsys):
    seen = stub_tracer(cs, monkeypatch, 2, [39])

    def rmsnorm_bwd_bf16():
        return None

    with pytest.raises(SystemExit) as exc:
        cs.device_ms(rmsnorm_bwd_bf16, iters=20)
    assert exc.value.code != 0
    assert seen == [1, 20] * cs.TRACE_TRIES
    assert "rmsnorm_bwd_bf16 at test_torch_trace_rule.py:" in capsys.readouterr().err


def test_device_top_fails_too_and_names_the_function(cs, monkeypatch, capsys):
    stub_tracer(cs, monkeypatch, 4, [0])

    def timed():
        return None

    with pytest.raises(SystemExit):
        cs.device_top(timed)
    assert "timed" in capsys.readouterr().err


def event(name, start, end):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start))


MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_counts_only_the_kernels_after_the_marker(cs):
    events = [event("warm_call", 0, 5), event(MARK, 6, 600), event("k", 601, 611),
              event("k", 612, 622), event("sum", 623, 624)]
    assert sorted(cs.after_marker(events)) == [("k", 2, 20), ("sum", 1, 1)]


@pytest.mark.parametrize("marks", [0, 2])
def test_a_trace_without_one_marker_counts_nothing(cs, marks):
    events = [event(MARK, 10 * i, 10 * i + 5) for i in range(marks)] + [event("k", 100, 110)]
    assert cs.after_marker(events) == []
