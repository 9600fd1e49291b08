"""The readers of the metrics that rest on the program's own spans and
counters (``program_spans``, ``metrics/``): on hand-made snapshots and
profiles, on a program without the tracer, and on a CPU window of the stream
driver under a CPU profiler.

    python -m pytest jpegbench/ -q
"""

import sys
import time
from typing import NamedTuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jpeg_gpu_tpu_torch.utils
from jpeg_gpu_tpu_torch.utils import trace
from jpegbench import cells, drivers, program_spans
from jpegbench.observed import Observed
from jpegbench.profile import Profile
from jpegbench.test_jpegbench_traffic import pool_of, small

SEED = 2**31 + 7
NEW = ["parse_ms", "verdict_wait_ms", "launch_ms", "producer_offcpu_pct",
       "consumer_offcpu_pct", "idle_launch_pct", "k3_rounds_per_frame"]
# perf_counter_ns is this far behind the profiler's clock in the hand-made spans.
OFFSET_NS = 5_000_000_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int
    clock_start_ns: int
    clock_end_ns: int

    @property
    def wall_ns(self):
        return self.end_ns - self.start_ns


class Snap(NamedTuple):
    spans: tuple
    counters: dict


def span(name, a, b, cpu=None):
    """A span from a to b seconds on the profiler's clock, ``cpu`` seconds on
    the CPU (all of it by default)."""
    a_ns, b_ns = int(a * 1e9), int(b * 1e9)
    cpu_ns = b_ns - a_ns if cpu is None else int(cpu * 1e9)
    return Span(name, a_ns - OFFSET_NS, b_ns - OFFSET_NS, cpu_ns, a_ns, b_ns)


def read(metric, snap, monkeypatch, profile_=None):
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    if profile_ is None:
        profile_ = Profile([], [("window", 0.0, 100.0)])
    o = Observed("stream", 1.0, [], {}, None, profile=profile_)
    return cells.load("mjpeg-1080p.scan").reader(metric)(o)


# Two frames: the producer parses, plans and uploads each; the consumer
# decodes it (the verdict inside) and runs K1.
FRAMES = (
    span("host.parse", 0.0, 1.0, cpu=0.5), span("engine.plan_frame", 1.0, 3.0, cpu=2.0),
    span("host.destuff", 1.0, 1.5), span("engine.upload_frame", 3.0, 3.5, cpu=0.5),
    span("host.parse", 4.0, 5.0, cpu=1.0), span("engine.plan_frame", 5.0, 7.0, cpu=1.0),
    span("engine.upload_frame", 7.0, 7.5, cpu=0.0),
    span("engine.decode_frame", 4.0, 6.0, cpu=1.0), span("engine.scan_verdict", 4.5, 5.0, cpu=0.5),
    span("pipeline.decode_rgb_soa", 6.0, 7.0, cpu=0.5),
    span("engine.decode_frame", 8.0, 11.0, cpu=1.5), span("engine.scan_verdict", 8.5, 9.5, cpu=0.5),
    span("pipeline.decode_rgb_soa", 11.0, 12.0, cpu=1.0),
)
COUNTERS = {"engine.scan_frames": 2, "engine.scan_rounds": 13}


@pytest.mark.parametrize("metric,value", [
    ("parse_ms", 1000.0),                          # two parses of 1 s
    ("verdict_wait_ms", 750.0),                    # 0.5 s and 1 s
    ("launch_ms", (2 + 1 + 3 + 1 - 1.5) / 2 * 1e3),
    # wall 1+2+0.5+1+2+0.5 = 7, CPU 0.5+2+0.5+1+1+0 = 5
    ("producer_offcpu_pct", 100 * 2 / 7),
    # wall 7 less the verdicts' 1.5; off the CPU 7 - 4 = 3 less the verdicts' 0.5
    ("consumer_offcpu_pct", 100 * 2.5 / 5.5),
    ("k3_rounds_per_frame", 6.5),
])
def test_readers_on_a_hand_made_snapshot(metric, value, monkeypatch):
    assert read(metric, Snap(FRAMES, COUNTERS), monkeypatch) == pytest.approx(value)


def test_idle_launch_pct_on_hand_made_gaps(monkeypatch):
    """Window [0, 10], the card busy [1, 2] and [5, 6]: idle 8 s.  The
    consumer inside the program [0.5, 3] and [4, 5.5], waiting for the
    verdict [1.5, 2.5]: idle and inside not waiting [0.5, 1], [2.5, 3] and
    [4, 5], 2 s: 25 %.  The producer's spans do not count."""
    snap = Snap((span("engine.decode_frame", 0.5, 3.0), span("engine.scan_verdict", 1.5, 2.5),
                 span("pipeline.decode_rgb_soa", 4.0, 5.5), span("engine.plan_frame", 0.0, 10.0)),
                {})
    p = Profile([("index_scan_kernel", 1.0, 2.0), ("fused_rgb_kernel", 5.0, 6.0),
                 ("decode_kernel", 11.0, 12.0)],
                [("window", 0.0, 10.0)])
    assert read("idle_launch_pct", snap, monkeypatch, p) == pytest.approx(25.0)
    # Spans that overlap each other and the window's edges count once.
    snap = Snap((span("engine.decode_frame", -1.0, 3.0), span("engine.decode_frame", 2.0, 3.0),
                 span("pipeline.decode_rgb_soa", 6.0, 11.0)), {})
    # Idle and inside: [0, 1], [2, 3], [6, 10] = 6 of 8.
    assert read("idle_launch_pct", snap, monkeypatch, p) == pytest.approx(75.0)


def test_a_window_without_a_scan_reads_no_wait_and_no_round(monkeypatch):
    """Restart markers: the frames bypass K3, so a decoded frame waits 0 ms
    for a verdict and runs 0 rounds; a window that scanned one frame of two
    reads half its wait and rounds."""
    snap = Snap((span("engine.decode_frame", 0.0, 1.0), span("pipeline.decode_rgb_soa", 1.0, 2.0)),
                {})
    assert read("verdict_wait_ms", snap, monkeypatch) == 0.0
    assert read("k3_rounds_per_frame", snap, monkeypatch) == 0.0
    assert read("launch_ms", snap, monkeypatch) == pytest.approx(2000.0)
    snap = Snap(snap.spans + (span("engine.decode_frame", 2.0, 4.0),
                              span("engine.scan_verdict", 2.5, 3.5)),
                {"engine.scan_frames": 1, "engine.scan_rounds": 5})
    assert read("verdict_wait_ms", snap, monkeypatch) == pytest.approx(500.0)
    assert read("k3_rounds_per_frame", snap, monkeypatch) == pytest.approx(2.5)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_gives_none(metric, monkeypatch):
    """No spans, no profile, or a program without the tracer: the metric is
    left out, and nothing raises."""
    assert read(metric, Snap((), {}), monkeypatch) is None
    o = Observed("stream", 1.0, [], {}, None, profile=None)
    assert cells.load("mjpeg-1080p.scan").reader(metric)(o) is None
    monkeypatch.setitem(sys.modules, "jpeg_gpu_tpu_torch.utils.trace", None)
    monkeypatch.delattr(jpeg_gpu_tpu_torch.utils, "trace")
    o = Observed("stream", 1.0, [], {}, None, profile=Profile([], [("window", 0.0, 1.0)]))
    assert program_spans.snapshot(o) is None
    assert cells.load("mjpeg-1080p.scan").reader(metric)(o) is None


def test_every_new_metric_has_its_entry():
    c = cells.load("mjpeg-1080p.scan")
    entries = {m["name"]: m for m in c.per_layer}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "device_ms_per_frame" and m["workloads"] == ["mjpeg-1080p.scan"]
        assert m["source"] == ("program_counter" if name == "k3_rounds_per_frame"
                               else "program_span")


def test_a_cpu_window_of_the_stream_under_a_profiler():
    """The stream driver's window on the CPU with a CPU profiler on, as a
    traced run is on the card: the program's spans of both threads are the
    session, and every reader reads them."""
    c = small("mjpeg-1080p.scan")
    pool = pool_of(c, SEED)
    spans = drivers.Spans(enabled=True)
    ctx = drivers.Context(c.config, c.traffic, pool, SEED, torch.device("cpu"), True, spans)
    c.driver.window(ctx, 0, warm=True)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns() / 1e9
    run = c.driver.window(ctx, 0.3)
    t1 = time.time_ns() / 1e9
    prof.stop()
    o = Observed("stream", 1.0, c.driver.completed(run, pool), spans.seconds, run,
                 profile=Profile([], [("window", t0, t1)]))
    values = {m: c.reader(m)(o) for m in NEW}
    assert all(v is not None for v in values.values()), values
    frames = len(run.pool_index)
    snap = program_spans.snapshot(o)
    decoded = program_spans.spans(snap, ["engine.decode_frame"])
    assert len(decoded) == frames
    assert snap.counters["engine.scan_frames"] == frames
    assert values["k3_rounds_per_frame"] >= 1
    # The producer and the consumer are two threads; the consumer's spans
    # lie inside the harness's own.
    assert {s.thread for s in decoded} != {s.thread for s in program_spans.spans(
        snap, ["engine.plan_frame"])}
    harness = (sum(spans.seconds["consumer.decode_frame"])
               + sum(spans.seconds["consumer.decode_rgb"])) / frames * 1e3
    assert 0 < values["launch_ms"] + values["verdict_wait_ms"] <= harness
    # Without a card nothing is on the device: every idle second is in the
    # window, and the consumer's share of it lies between 0 and 100 %.
    assert 0 < values["idle_launch_pct"] < 100
