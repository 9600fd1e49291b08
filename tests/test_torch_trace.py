"""The port's tracer (``jpeg_gpu_tpu_torch.utils.trace``): off and on, the
profiler's switch and clock, nesting, threads, the buffer's bound, and one
frame through the engine's halves on the CPU."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from jpeg_gpu_tpu_torch.engine import device_entropy, pipeline
from jpeg_gpu_tpu_torch.host import entropy_native
from jpeg_gpu_tpu_torch.host.parser import parse
from jpeg_gpu_tpu_torch.ops.entropy_device import plan_tensors
from jpeg_gpu_tpu_torch.testing import corpus
from jpeg_gpu_tpu_torch.utils import trace

CPU = torch.device("cpu")


def _names(snap):
    return [s.name for s in snap.spans]


def test_off_records_nothing_and_returns_one_object():
    with trace.enable():
        pass
    assert trace.span("a") is trace.span("b", 7)
    with trace.span("a"):
        trace.count("c")
    snap = trace.snapshot()
    assert snap.spans == () and snap.counters == {}


def test_enable_starts_a_new_session():
    with trace.enable():
        with trace.span("first"):
            trace.count("c", 2)
    assert _names(trace.snapshot()) == ["first"]
    assert trace.snapshot().counters == {"c": 2}
    with trace.enable():
        with trace.span("second"):
            pass
    assert _names(trace.snapshot()) == ["second"]
    assert trace.snapshot().counters == {}


def test_a_running_profiler_turns_tracing_on():
    """prof.start()/prof.stop(), as the benchmark's traced window runs it:
    PyTorch's flag torch.autograd.profiler._is_profiler_enabled is what the
    tracer reads, so this fails if an upgrade stops setting it."""
    with trace.enable():
        with trace.span("before"):
            pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with trace.span("inside", 3):
            trace.count("engine.scan_frames")
    finally:
        prof.stop()
    with trace.span("after"):
        trace.count("engine.scan_frames")
    snap = trace.snapshot()
    assert _names(snap) == ["inside"] and snap.spans[0].frame == 3
    assert snap.counters == {"engine.scan_frames": 1}


def test_nesting_parents_self_time_and_cpu_time():
    with trace.enable():
        with trace.span("outer", 5):
            time.sleep(0.02)
            with trace.span("inner"):
                time.sleep(0.03)
        with trace.span("next", cpu=False):
            pass
    outer, inner, nxt = trace.snapshot().spans
    assert (outer.parent, inner.parent, nxt.parent) == (-1, 0, -1)
    assert outer.frame == inner.frame == nxt.frame == 5    # the thread's last frame
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    # Self time: the outer span less the part its child covers.
    assert outer.wall_ns - inner.wall_ns >= 0.02e9
    assert inner.wall_ns >= 0.03e9
    # A sleeping thread runs no CPU: its wall time is off the CPU.
    assert inner.wall_ns - inner.cpu_ns >= 0.027e9
    assert 0 <= inner.cpu_ns <= inner.wall_ns
    assert nxt.cpu_ns is None and nxt.wall_ns >= 0        # opened with cpu=False
    assert outer.clock_start_ns - outer.start_ns == trace.snapshot().offset_ns


def test_an_open_span_is_left_out():
    with trace.enable():
        with trace.span("open"):
            with trace.span("closed"):
                pass
            snap = trace.snapshot()
    assert _names(snap) == ["closed"] and snap.spans[0].parent == -1


def test_threads_at_once():
    """More threads than cores, a short switch interval: every span and count
    is kept, and each child's parent is its own thread's span."""
    n_threads, n_spans = 12, 150
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with trace.span("outer", 1000 * k + i):
                    with trace.span("inner"):
                        trace.count("n")

        with trace.enable():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert len(snap.spans) == 2 * n_threads * n_spans and snap.dropped == 0
    assert snap.counters == {"n": n_threads * n_spans}
    assert len({s.thread for s in snap.spans}) == n_threads
    for s in snap.spans:
        if s.name == "inner":
            p = snap.spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread and p.frame == s.frame
    assert len({s.frame for s in snap.spans}) == n_threads * n_spans


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with trace.enable():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    snap = trace.snapshot()
    assert _names(snap) == ["s0", "s1", "s2"] and snap.dropped == 2


FRAME_SPANS = ["host.parse", "engine.plan_frame", "host.destuff", "host.scan_windows",
               "engine.upload_frame", "engine.decode_frame", "engine.scan",
               "engine.scan_verdict", "engine.k2", "engine.assemble",
               "pipeline.decode_rgb_soa"]


def _one_frame(data):
    """parse, plan_frame, upload_frame, decode_frame and decode_rgb_soa of
    one frame under the tracer: (its snapshot, the parse, decode_frame's
    result, the uploaded frame)."""
    with trace.enable():
        parsed = parse(data)
        hdr = parsed.header
        spec = pipeline.PipelineSpec.from_header(hdr, exact=True, upsample="nearest")
        qts = plan_tensors([hdr.quant_for(c).values for c in hdr.components], CPU)
        frame = device_entropy.upload_frame(device_entropy.plan_frame(parsed), CPU)
        res = device_entropy.decode_frame(frame, soa=True, check_errors=False)
        pipeline.decode_rgb_soa(spec, pipeline.fused_rgb_geometry(spec), res.coefs, qts)
    return trace.snapshot(), parsed, res, frame


def test_one_frame_through_the_engine_halves(monkeypatch):
    """parse, plan_frame, upload_frame, decode_frame and decode_rgb_soa on a
    stream without restart markers: each named span once, one frame id, the
    children under their parents, and the scan's counters; the native byte
    walks' counters once each, and on the numpy fallback (the host library
    marked unavailable) not at all, with the same spans."""
    data = corpus.own_jpeg(corpus.synthetic_rgb(40, 56, seed=1), "4:2:0").data
    assert entropy_native.available()
    snap, parsed, res, frame = _one_frame(data)
    assert sorted(_names(snap)) == sorted(FRAME_SPANS)
    assert {s.frame for s in snap.spans} == {parsed.frame_id}
    assert frame.frame_id == frame.plan.frame_id == parsed.frame_id
    by = {s.name: s for s in snap.spans}

    def parent(name):
        i = by[name].parent
        return snap.spans[i].name if i >= 0 else None

    assert parent("host.destuff") == parent("host.scan_windows") == "engine.plan_frame"
    for child in ("engine.scan", "engine.scan_verdict", "engine.k2", "engine.assemble"):
        assert parent(child) == "engine.decode_frame"
    assert parent("host.parse") is parent("pipeline.decode_rgb_soa") is None
    # The thread's CPU time where a metric reads it, and only there.
    assert {s.name for s in snap.spans if s.cpu_ns is not None} == {
        "host.parse", "engine.plan_frame", "engine.upload_frame", "engine.decode_frame",
        "engine.scan_verdict", "pipeline.decode_rgb_soa"}
    scan_counters = {"engine.scan_frames": 1, "engine.scan_rounds": int(res.specsync_stats[0])}
    assert snap.counters == {**scan_counters, "host.native_markers": 1,
                             "host.native_windows": 1}
    assert res.specsync_stats[0] >= 1
    assert parse(data).frame_id != parsed.frame_id

    monkeypatch.setattr(entropy_native, "available", lambda: False)
    snap, parsed, res, _ = _one_frame(data)
    assert sorted(_names(snap)) == sorted(FRAME_SPANS)
    assert snap.counters == scan_counters


def test_spans_share_the_profilers_clock():
    """A record_function range opened inside a span starts where the span
    does, on the profiler's clock: within 200 us (the median of nine; the
    first range pays the profiler's first-call costs and is left out)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for i in range(10):
            with trace.span(f"span{i}"):
                with record_function(f"range{i}"):
                    time.sleep(0.001)
    finally:
        prof.stop()
    ranges = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in trace.snapshot().spans}
    gaps = sorted(abs(ranges[f"range{i}"] - spans[f"span{i}"].clock_start_ns)
                  for i in range(1, 10))
    assert gaps[4] < 200_000
