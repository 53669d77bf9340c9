"""The span readers' arithmetic on synthetic spans, and their choice of the
calls traced on the device alone in a traced tiny run on the CPU."""

import time
import types

import pytest

from xmrbench import harness, spans

from conftest import TINY_MIXES


def _span(name, sid, parent=None, call=None, ms=1.0, device_ms=None, **attrs):
    return types.SimpleNamespace(name=name, sid=sid, parent=parent,
                                 call=sid if call is None else call, host_ms=ms,
                                 device_ms=device_ms, attrs=attrs)


def _calls(engine, sids, queries=1, marshal_ms=0.5, table_ms=0.25):
    """One root a call, each with a marshal span and a table span."""
    out = []
    for sid in sids:
        out += [_span("serve.online", sid, engine=engine, queries=queries),
                _span("serve.marshal", sid + 1, sid, sid, ms=marshal_ms),
                _span("mscm.table", sid + 2, sid, sid, device_ms=table_ms)]
    return out


def test_select_takes_the_newest_engines_first_calls():
    old = _calls(1, [10, 20], marshal_ms=9.0)
    new = _calls(2, [30, 40, 50], marshal_ms=0.5) + _calls(2, [60], marshal_ms=7.0)
    picked = spans.select(old + new, "online", 3)
    assert {s.call for s in picked} == {30, 40, 50}
    assert spans.host_ms(picked, ("serve.marshal",), 3) == pytest.approx(0.5)
    assert spans.device_ms(picked, ("mscm.table",), 3) == pytest.approx(0.25)


@pytest.mark.parametrize("queries,want", [(4, {10, 20}), (2, {10})])
def test_select_sums_the_calls_queries(queries, want):
    calls = _calls(1, [10, 20, 30], queries=2)
    picked = spans.select(calls, "online", queries)
    assert {s.call for s in picked} == want


def test_nothing_to_read_is_none():
    calls = _calls(1, [10, 20], queries=2)
    assert spans.select(calls, "batch", 2) is None           # another mode
    assert spans.select(calls, "online", 3) is None          # the sums miss
    assert spans.select(calls, "online", 8) is None          # too few calls
    picked = spans.select(calls, "online", 2)
    assert spans.host_ms(picked, ("serve.wait",), 2) is None          # no such span
    assert spans.device_ms(picked, ("serve.marshal",), 2) is None     # no interval


def test_host_and_device_sum_over_names():
    calls = [_span("serve.batch", 1, engine=1, queries=4),
             _span("tree.beam_select", 2, 1, 1, ms=2.0, device_ms=0.4),
             _span("plan.gather_select", 3, 1, 1, ms=1.0, device_ms=0.2),
             _span("tree.beam_select", 4, 1, 1, ms=1.0, device_ms=0.2)]
    picked = spans.select(calls, "batch", 4)
    names = ("tree.beam_select", "plan.gather_select")
    assert spans.device_ms(picked, names, 4) == pytest.approx(0.2)
    assert spans.host_ms(picked, names, 4) == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_traced_run_selects_the_device_alone_window(tiny_cell, mode):
    """A traced run leaves the traced calls' spans, then the breakdown's,
    in the program's buffer; the readers take the first window's alone, and
    return None off the chip."""
    from repro_torch import obs

    obs.clear()
    cell = tiny_cell(mode)
    result, _ = harness.run_cell(cell, 2**31 + 9, 0.2, True, device="cpu",
                                 t_start=time.perf_counter())
    assert result["correct"] is True
    mix = TINY_MIXES[mode]
    traced_q = mix["trace_calls"] * mix["call_queries"]
    buffered = obs.spans()
    roots = [s for s in buffered if s.parent is None and s.name == f"serve.{mode}"]
    assert len(roots) == mix["trace_calls"] + mix["breakdown_calls"]
    picked = spans.select(buffered, mode, traced_q)
    assert {s.call for s in picked} == {r.sid for r in roots[:mix["trace_calls"]]}
    assert spans.host_ms(picked, ("serve.marshal",), traced_q) > 0
    assert spans.host_ms(picked, ("serve.run",), traced_q) > 0
    rec = harness.Record(mode=mode, traced_queries=traced_q)
    for name in ("marshal_ms", "dispatch_ms", "device_wait_ms", "table_ms",
                 "beam_select_ms"):
        assert harness.load_reader(f"{name}.{mode}")(rec) is None   # not on the chip
    assert not any(n.startswith(("marshal", "dispatch", "table", "beam", "device_wait"))
                   for n in result["metrics"])
