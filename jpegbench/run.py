"""Run one cell of the benchmark once.

    python -m jpegbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``jpegbench/``
and the program, ``jpeg_gpu_tpu_torch``, on a machine with the cards the
cell asks for.  The run makes its traffic from ``--seed``
(``traffic_gen``), warms up on that traffic, measures for ``--seconds``
(``drivers``), compares what the timed path produced with the plain
reference (``reference``), and prints as the last line of its standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics, from a window
profiled only where one of them reads the card's trace; ``--trace 1``: its
per-layer metrics, from a profiled window with the harness's spans),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also printed as the last lines of
standard error.

Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from jpegbench import cells  # noqa: E402

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_gpu_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among ``sys.modules``, compared whole
    (``jpeg_gpu_tpu_torch`` is not ``jpeg_gpu_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_caches() -> None:
    """Build and kernel caches of PyTorch and Triton inside the checkout, at
    fixed paths (the program's own kernels build into its package's
    ``_build`` directories)."""
    base = cells.ROOT / ".jpegbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def card_line() -> Optional[str]:
    """The card's name and power limit, from nvidia-smi, where it runs."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _launches() -> Dict[str, int]:
    from jpegbench.profile import FAMILIES

    return {fam: getattr(sys.modules[mod], "launches", 0) if mod in sys.modules else 0
            for fam, (_, mod) in FAMILIES.items()}


def run_cell(cell: "cells.Cell", seed: int, seconds: float, trace: bool, device,
             t_start: float, exact: Optional[bool] = None) -> dict:
    """One run of ``cell`` on ``device`` (the tests pass the CPU; the
    command, the card), its result as printed.  The program runs with the
    configuration's ``exact`` option unless ``exact`` is given: ``False`` is
    the program's float path in place of the exact one, the comparison's
    control, which has to come out not correct."""
    import torch

    from jpegbench import drivers, profile
    from jpegbench.observed import Observed

    cuda = device.type == "cuda"
    driver = cell.driver
    wanted = cell.per_layer if trace else cell.end_to_end
    # A traced run profiles its window, and so does an untraced one whose
    # end-to-end metrics read the card's trace.
    profiled = cuda and (trace or any(m.get("source") == "device_trace" for m in wanted))
    pool = driver.make_pool(cell.config, cell.traffic, seed)
    spans = drivers.Spans(enabled=trace, annotate=profiled)
    ctx = drivers.Context(cell.config, cell.traffic, pool, seed, device,
                          cell.config["exact"] if exact is None else exact, spans)

    driver.window(ctx, 0, warm=True)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity

        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    before = _launches()
    got = driver.window(ctx, seconds)
    launched = {k: v - before[k] for k, v in _launches().items()}
    if prof is not None:
        torch.cuda.synchronize(device)
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    facts = driver.completed(got, pool)
    obs = Observed(cell.traffic["kind"], setup_s, facts, spans.seconds, got, launches=launched)
    verdict = driver.verdict(got, pool, cell.config)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct, "attempted": len(facts), "failed": verdict.failed}
    breakdown = None
    if prof is not None:
        obs.profile = profile.read_profile(prof, spans.intervals)
    if trace and prof is not None:
        busy_s, window_s = profile.busy(obs.profile)
        device_info.update(busy_s=busy_s, window_s=window_s)
        breakdown = {"device_ops": profile.device_ops(obs.profile),
                     "idle_gaps": profile.idle_gaps(obs.profile)}
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict.checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's float path in place of the configuration's exact "
                         "one (the comparison's control: its result has to read not correct)")
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"jpegbench: the cell asks for {cell.chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, exact=False if args.control else None)
    leaked = forbidden_modules()
    if leaked:
        print(f"jpegbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    card = card_line()
    if card:
        result["device"]["card"] = card
        print(f"card: {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
