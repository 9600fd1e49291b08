"""The timed loops, one file a traffic kind: ``drivers/<kind>.py``, found by
the ``kind`` of a traffic mix as ``metrics/<metric>.py`` is found by a
metric's name.  A new kind of traffic is a new file here; nothing else
names one.

A driver module holds:

* ``CONFIG_KEYS``, ``TRAFFIC_KEYS``: every key of a configuration file and
  of a traffic mix that it reads (besides :data:`PROSE_KEYS`).  A file with
  another key is refused (:func:`validate`), so that no file states what
  the run does not do.
* ``GUARANTEES``: the guarantees its comparison holds the program to; a
  configuration that states another is refused.
* ``validate(config, traffic)``: refuses values it does not implement.
* ``make_pool(config, traffic, seed)``: the distinct inputs
  (``traffic_gen.Frame``), a function of the seed.
* ``window(ctx, seconds, warm)``: one window on ``ctx`` (a
  :class:`Context`), its run; ``warm`` is the warm-up, which drives the
  same shapes and keeps nothing.  The run has ``wall_s``.
* ``completed(run, pool)``: the ``Facts`` of every input the window
  completed, in order.
* ``verdict(run, pool, config)``: ``check.Verdict``, the comparison with
  the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import pathlib
import sys
import time
from typing import Dict, List, Sequence

HERE = pathlib.Path(__file__).resolve().parent

# Keys of a configuration file that describe it and that nothing runs by.
PROSE_KEYS = frozenset({"name", "source", "what", "assumed", "reduced", "reduced_from"})


class Spans:
    """The harness's spans on the host clock: (name, start, end) in order,
    and with ``annotate`` the window as a ``record_function`` range
    ``jpegbench.window``, which places the host clock on the profiler's.
    Disabled, a span costs nothing, and only an annotated window is kept."""

    def __init__(self, enabled: bool = False, annotate: bool = False):
        self.enabled, self.annotate = enabled, annotate
        self.intervals: List[tuple] = []

    @property
    def seconds(self) -> Dict[str, List[float]]:
        """Each span's durations by name."""
        out: Dict[str, List[float]] = {}
        for name, a, b in self.intervals:
            out.setdefault(name, []).append(b - a)
        return out

    @contextlib.contextmanager
    def _span(self, name: str):
        if self.annotate and name == "window":
            import torch

            ctx = torch.profiler.record_function("jpegbench." + name)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            t = time.perf_counter()
            yield
            self.intervals.append((name, t, time.perf_counter()))

    def __call__(self, name: str):
        if self.enabled or (self.annotate and name == "window"):
            return self._span(name)
        return contextlib.nullcontext()


@dataclasses.dataclass
class Context:
    """What a driver's window runs on: the cell's configuration and traffic
    mix, its pool, the seed, the device, the program's ``exact`` option, the
    spans of the timed window, and whatever the driver keeps between its
    warm-up and its window (``state``)."""

    config: dict
    traffic: dict
    pool: Sequence
    seed: int
    device: "torch.device"
    exact: bool
    spans: Spans
    state: dict = dataclasses.field(default_factory=dict)


_LOADED: Dict[str, object] = {}


def load(kind: str):
    """The driver of traffic ``kind``: ``drivers/<kind>.py``."""
    if kind not in _LOADED:
        path = HERE / f"{kind}.py"
        if not path.is_file():
            raise ValueError(f"no driver for traffic kind {kind!r} ({path.name})")
        name = f"jpegbench_driver_{kind}"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        _LOADED[kind] = module
    return _LOADED[kind]


def validate(driver, config: dict, traffic: dict) -> None:
    """Refuse a configuration or a traffic mix with a key the driver does not
    read, without one it needs, or with a guarantee it does not hold."""
    extra = set(config) - PROSE_KEYS - set(driver.CONFIG_KEYS)
    missing = set(driver.CONFIG_KEYS) - set(config)
    t_extra = set(traffic) - {"kind"} - set(driver.TRAFFIC_KEYS)
    t_missing = set(driver.TRAFFIC_KEYS) - set(traffic)
    for what, keys in (("configuration keys nothing reads", extra),
                       ("configuration keys missing", missing),
                       ("traffic keys nothing reads", t_extra),
                       ("traffic keys missing", t_missing)):
        if keys:
            raise ValueError(f"{config.get('name')}/{traffic['kind']}: {what}: {sorted(keys)}")
    unheld = set(config["guarantees"]) - set(driver.GUARANTEES)
    if unheld:
        raise ValueError(f"{config['name']}: guarantees the comparison does not hold: "
                         f"{sorted(unheld)}")
    if config["exact"] is not True:
        raise ValueError(f"{config['name']}: exact must be true: the comparison has a limit "
                         "for the exact decode only")
    driver.validate(config, traffic)
