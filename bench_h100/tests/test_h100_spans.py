"""CPU tests of ``spans.py``, the readers of the program's ``hisparse.*``
spans, on synthetic event lists shaped as the card's profiler gives them
(torch ops with their own correlation ids, runtime calls with CUPTI's,
device events linked to a torch op or, for a ``ctypes`` launch, to
nothing), and of ``read`` on a real CPU profile.  Run from the
repository's root:

    python -m pytest bench_h100/tests -q
"""
from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_tiny import ROOT  # noqa: F401  (puts the root on sys.path)

from bench_h100 import spans, trace


def host(name, start, end, corr, link=0, annotation=False, thread=1):
    return spans.Event(name, False, corr, link, thread, start, end,
                       annotation)


def dev(name, start, end, corr, link=0, annotation=False):
    return spans.Event(name, True, corr, link, 1, start, end, annotation)


def call_trace():
    """Two calls in a 100 µs window.  Call 1: a forward with an x span (a
    torch op whose kernel links to it) and a ctypes kernel launched in the
    forward (no link: its runtime call names it).  The torch op's
    correlation id 7 is also a runtime call's CUPTI id, as happens."""
    return [
        host(trace.WINDOW, 0, 100, 1, annotation=True),
        host(trace.REQUEST, 1, 49, 2, annotation=True),
        host("hisparse.forward", 2, 40, 3, annotation=True),
        host("hisparse.x", 3, 10, 4, annotation=True),
        host("aten::index", 4, 9, 7),
        host("cudaLaunchKernel", 5, 6, 50, link=7),
        host("cudaLaunchKernel", 20, 21, 7),           # the ctypes launch
        host("hisparse.stripe_fold", 30, 39, 5, annotation=True),
        host("aten::sum", 31, 38, 8),
        host("cudaLaunchKernel", 32, 33, 51, link=8),
        dev("index_elementwise_kernel", 12, 16, 50, link=7),
        dev("wavepack_kernel", 22, 60, 7),
        dev("reduce_kernel", 60, 64, 51, link=8),
        dev("hisparse.x", 12, 16, 4, annotation=True),  # a span's mirror
        # call 2: a forward whose kernel runs past the window's end
        host(trace.REQUEST, 70, 95, 9, annotation=True),
        host("hisparse.forward", 71, 90, 10, annotation=True),
        host("cudaLaunchKernel", 72, 73, 52),
        dev("wavepack_kernel", 80, 110, 52),
    ]


def rec_of(evs, driver="calls", requests=2):
    """The traced record's keys that the readers take, as ``trace.read``
    and the harness give them, with ``spans.read``'s two."""
    window = next(e for e in evs if e.name == trace.WINDOW)
    rec = spans.attribute(evs)
    rec.update(driver=driver, requests=requests,
               window_s=(window.end - window.start) * 1e-6)
    return rec


def test_spans_nest_by_time_on_their_thread():
    rec = rec_of(call_trace())
    names = [(s[2], s[4]) for s in rec["spans"]]
    assert names == [("hisparse.forward", -1), ("hisparse.x", 0),
                     ("hisparse.stripe_fold", 0), ("hisparse.forward", -1)]
    assert rec["spans"][1][:2] == (3, 10)


def test_device_work_links_up_to_its_ancestors():
    """The index kernel links to ``aten::index`` inside ``hisparse.x``;
    the ctypes kernel has no link and its runtime call at 20 µs lies in
    the forward alone; the reduce links to ``aten::sum`` in the stripe
    fold; the mirror is no device work."""
    rec = rec_of(call_trace())
    spn = rec["spans"]
    got = [(d[2], [spn[i][2] for i in d[3]]) for d in rec["device_spans"]]
    assert got == [
        ("index_elementwise_kernel", ["hisparse.x", "hisparse.forward"]),
        ("wavepack_kernel", ["hisparse.forward"]),
        ("reduce_kernel", ["hisparse.stripe_fold", "hisparse.forward"]),
        ("wavepack_kernel", ["hisparse.forward"])]
    assert spans.xt_us(rec) == pytest.approx(4 / 2)
    assert spans.stripe_fold_us(rec) == pytest.approx(4 / 2)
    assert spans.attributed_pct(rec, spans.CALLS) == pytest.approx(100.0)
    # queries read nothing from a call trace, and a program without
    # spans gives nothing to read
    assert spans.combine_ms(rec) is None
    bare = rec_of([e for e in call_trace()
                   if not e.name.startswith("hisparse.")])
    assert bare["spans"] == []
    assert all(d[3] == [] for d in bare["device_spans"])
    assert {f(bare) for f in spans.READERS.values()} == {None}


def test_program_idle_is_the_intersection_with_call_spans():
    """Device busy [12, 16], [22, 64], [80, 100] of the window; call spans
    [2, 40] and [71, 90]: idle inside them [2, 12], [16, 22], [71, 80],
    25 µs of 100, whatever a gap's middle says."""
    rec = rec_of(call_trace())
    assert spans.program_idle_pct(rec) == pytest.approx(25.0)
    assert spans.overlap([(0, 2), (5, 9)], [(1, 6), (8, 20)]) == 3


def query_trace():
    """One query of two iterations: each step holds a forward, a combine
    tree (a forward of its own) and a host read."""
    evs = [host(trace.WINDOW, 0, 1000, 1, annotation=True)]
    c = 100
    for k, t in enumerate((10, 500)):
        evs += [
            host("hisparse.step", t, t + 300 + 100 * k, c, annotation=True),
            host("hisparse.forward", t + 10, t + 50, c + 1,
                 annotation=True),
            host("cudaLaunchKernel", t + 20, t + 21, c + 2),
            host("hisparse.combine", t + 60, t + 120, c + 3,
                 annotation=True),
            host("hisparse.forward", t + 70, t + 110, c + 4,
                 annotation=True),
            host("cudaLaunchKernel", t + 80, t + 81, c + 5),
            host("hisparse.sync", t + 150, t + 250 + 50 * k, c + 6,
                 annotation=True),
            dev("wavepack_kernel", t + 30, t + 130, c + 2),
            dev("wavepack_kernel", t + 130, t + 190, c + 5),
        ]
        c += 10
    return evs


def test_combine_and_host_time_of_an_iteration():
    rec = rec_of(query_trace(), driver="queries", requests=1)
    # the combine's kernels, 60 µs each step, a query's ms
    assert spans.combine_ms(rec) == pytest.approx(120 / 1e3)
    # step less its sync: 300 - 100 and 400 - 150
    assert spans.host_ms_iter(rec) == pytest.approx(225 / 1e3)
    assert spans.attributed_pct(rec, ("hisparse.step",)) == \
        pytest.approx(100.0)
    assert spans.program_idle_pct(rec) is None
    assert spans.xt_us(rec) is None


def _prof_events(evs):
    """``prof.events()``-like records of ``evs``, as ``trace.device_work``
    takes them."""
    def fe(e):
        return types.SimpleNamespace(
            name=e.name, is_user_annotation=e.annotation,
            time_range=types.SimpleNamespace(start=e.start, end=e.end),
            device_type=(torch.autograd.DeviceType.CUDA if e.device
                         else torch.autograd.DeviceType.CPU))
    return [fe(e) for e in evs]


def test_trace_read_is_unchanged_by_spans():
    """``trace.read``'s device work and window are the same with the
    program's spans and their device mirrors as without them."""
    evs = call_trace()
    with_spans = trace.device_work(_prof_events(evs))
    without = trace.device_work(_prof_events(
        [e for e in evs if not e.name.startswith("hisparse.")]))
    for key in ("window_s", "busy_s", "device"):
        assert with_spans[key] == without[key]
    assert with_spans["breakdown"]["device_ops"] == \
        without["breakdown"]["device_ops"]
    assert [d[:3] for d in spans.attribute(evs)["device_spans"]] == [
        (s, e, n) for s, e, n in with_spans["device"]]


def test_read_on_a_cpu_profile():
    """``read`` takes the profiler's own events: spans recorded under a
    CPU profile nest, and no device interval is there; ``trace.read``
    adds them to the traced record."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function("hisparse.step"):
                with record_function("hisparse.sync"):
                    torch.ones(4).sum()
    rec = spans.read(prof)
    assert [(s[2], s[4]) for s in rec["spans"]] == [
        ("hisparse.step", -1), ("hisparse.sync", 0)]
    assert rec["device_spans"] == []
    assert 0 <= rec["spans"][0][0] <= rec["spans"][1][0]
    # the traced run's record holds them beside the device work
    traced = trace.read(prof)
    assert traced["spans"] == rec["spans"]
    assert traced["busy_s"] == 0 and traced["device"] == []
