"""The differential sweep on the port: 20 committed JPEGs against the CPU
path, libjpeg and the TPU run's checksums.

The port's counterpart of ``scripts/sweep_differential.py``.  That script
draws 14 random configs (sizes 9-229, qualities 30-96, gray, 4:4:4, 4:2:2,
4:2:0, 4:4:0, 4:1:1, restart intervals 0-3, nearest and fancy upsampling)
and pins 6 more (frames up to 48x4200, h2v4, 4:1:1 fancy), seed 2026, and
records each output's checksum in ``SWEEP_r05.json``.  Its inputs come from
Pillow, which the machine with the card need not have, so the 20 files are
committed in ``sweep_r05/`` beside this module (:func:`build_fixtures`
writes them where Pillow imports), with a manifest that holds each file's
sha256, the TPU run's checksum of its RGB (``rgb_sha_r05``) and, where the
reference compares with libjpeg (gray, 4:4:4 or fancy upsampling), libjpeg's
(``libjpeg_rgb_sha``).  The same directory holds the six inputs of
``scripts/specsync_device_artifact.py`` (``testing/specsync_artifact.py``).

:func:`run` decodes every file on a device, with the default entropy path
and with ``entropy="device"``, and holds the result to the host pipeline,
to both checksums and, where the machine's libjpeg serves RGB, to libjpeg
live.  Run it as

    python -m jpeg_gpu_tpu_torch.testing.sweep [--device cuda] [--out PATH]
    python -m jpeg_gpu_tpu_torch.testing.sweep --build-fixtures DIR

``--device`` is the card by default; the CPU runs only with ``--device
cpu``.  The command exits 1 when a config fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

FIXTURES = pathlib.Path(__file__).parent / "sweep_r05"
REFERENCE_ARTIFACT = pathlib.Path(__file__).resolve().parents[2] / "SWEEP_r05.json"

MODES = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1"]
PIL_MODES = ("4:4:4", "4:2:2", "4:2:0")
# (h, w, q, mode, restart, upsample): the reference's pinned configs, i = 14..19.
PINNED = [
    (48, 2100, 85, "4:2:0", 1, "fancy"),
    (40, 1200, 75, "4:4:4", 0, "nearest"),
    (48, 4200, 85, "4:2:0", 1, "nearest"),
    (64, 40, 85, "h2v4", 1, "nearest"),
    (48, 4200, 85, "4:2:0", 1, "fancy"),
    (40, 72, 85, "4:1:1", 1, "fancy"),
]
# The inputs of scripts/specsync_device_artifact.py: (config, mode, quality,
# encoder, (h, w)), each image drawn with seed 7.
SPECSYNC_CONFIGS = [
    ("gray-q85", None, 85, "pil", (120, 200)),
    ("444-q92", "4:4:4", 92, "pil", (96, 144)),
    ("420-q85", "4:2:0", 85, "pil", (128, 192)),
    ("422-q60", "4:2:2", 60, "pil", (112, 160)),
    ("420-q95", "4:2:0", 95, "pil", (80, 120)),
    ("440-q85", "4:4:0", 85, "own", (48, 96)),
]
STORE_NOTE = (
    "raster_eq_xla_store is null: the reference cross-checks its fused kernel's "
    "raster-major store against a post-kernel XLA store and its seam repair; K1 "
    "(csrc/pixel_fused.cu) has one store and no seams, so the check has no counterpart"
)


def _checksum(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def draw_configs(n: int = 14, seed: int = 2026) -> List[dict]:
    """The reference's configs: ``n`` random draws, then the pinned six."""
    rng = np.random.default_rng(seed)
    configs = []
    for i in range(n + len(PINNED)):
        if i >= n:
            h, w, q, mode, r, ups = PINNED[i - n]
        else:
            h = int(rng.integers(9, 230))
            w = int(rng.integers(9, 230))
            q = int(rng.integers(30, 97))
            gray = bool(rng.integers(0, 3) == 0)
            r = int(rng.integers(0, 4))
            ups = "fancy" if rng.integers(0, 2) else "nearest"
            mode = "gray" if gray else MODES[int(rng.integers(0, len(MODES)))]
        configs.append({"i": i, "h": h, "w": w, "q": q, "mode": mode, "restart": r,
                        "upsample": ups})
    return configs


def encode_config(cfg: dict) -> bytes:
    """The reference's encoder for a config: Pillow for gray, 4:4:4, 4:2:2
    and 4:2:0; the package's encoder (restart interval at least 1) for the
    modes Pillow cannot write."""
    from jpeg_gpu_tpu_torch.testing import corpus

    h, w, q, r, i = cfg["h"], cfg["w"], cfg["q"], cfg["restart"], cfg["i"]
    if cfg["mode"] == "gray":
        return corpus.pil_jpeg(corpus.synthetic_gray(h, w, seed=i), quality=q,
                               restart_marker_blocks=r)
    img = corpus.synthetic_rgb(h, w, seed=i)
    if cfg["mode"] in PIL_MODES:
        return corpus.pil_jpeg(img, quality=q, subsampling=cfg["mode"], restart_marker_blocks=r)
    return corpus.own_jpeg(img, subsampling=cfg["mode"], quality=q,
                           restart_interval=max(r, 1)).data


def encode_specsync(mode, quality: int, encoder: str, h: int, w: int) -> bytes:
    from jpeg_gpu_tpu_torch.testing import corpus

    if mode is None:
        return corpus.pil_jpeg(corpus.synthetic_gray(h, w, seed=7), quality=quality)
    img = corpus.synthetic_rgb(h, w, seed=7)
    if encoder == "own":
        return corpus.own_jpeg(img, subsampling=mode, quality=quality).data
    return corpus.pil_jpeg(img, quality=quality, subsampling=mode)


def libjpeg_checked(cfg: dict) -> bool:
    """Where the reference compares with libjpeg (sweep_differential.py:125-131)."""
    return cfg["mode"] in ("gray", "4:4:4") or cfg["upsample"] == "fancy"


def build_fixtures(out_dir, reference=REFERENCE_ARTIFACT) -> dict:
    """Write the 20 sweep files, the six scan inputs and ``manifest.json``
    into ``out_dir`` (needs Pillow).  The draw must give the reference
    artifact's configs; its checksums are copied, libjpeg's computed here."""
    import PIL

    import jpeg_gpu_tpu_torch as jt

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ref = json.loads(pathlib.Path(reference).read_text())
    keys = ("i", "h", "w", "q", "mode", "restart", "upsample")
    configs = draw_configs(ref["n_random"], ref["seed"])
    ref_configs = [{k: c[k] for k in keys} for c in ref["configs"]]
    if configs != ref_configs:
        raise ValueError(f"the draw does not give {reference}'s configs")
    sweep = []
    for cfg, rec in zip(configs, ref["configs"]):
        data = encode_config(cfg)
        name = f"{cfg['i']:02d}.jpg"
        (out_dir / name).write_bytes(data)
        entry = {**cfg, "file": name, "sha256": _sha256(data), "rgb_sha_r05": rec["rgb_sha"],
                 "store_xcheck": "raster_eq_xla_store" in rec}
        if libjpeg_checked(cfg):
            entry["libjpeg_rgb_sha"] = _checksum(jt.decode(data, impl="libjpeg"))
        sweep.append(entry)
    specsync = []
    for name, mode, q, enc, (h, w) in SPECSYNC_CONFIGS:
        data = encode_specsync(mode, q, enc, h, w)
        (out_dir / f"{name}.jpg").write_bytes(data)
        specsync.append({"config": name, "file": f"{name}.jpg", "h": h, "w": w, "quality": q,
                         "mode": mode or "gray", "encoder": enc, "seed": 7,
                         "sha256": _sha256(data)})
    manifest = {"seed": ref["seed"], "n_random": ref["n_random"],
                "n_pinned": ref["n"] - ref["n_random"], "pillow": PIL.__version__,
                "sweep": sweep, "specsync": specsync}
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def load_manifest(fixture_dir=FIXTURES) -> dict:
    return json.loads((pathlib.Path(fixture_dir) / "manifest.json").read_text())


def read_fixture(fixture_dir, entry: dict) -> bytes:
    """A committed file's bytes, checked against its manifest sha256."""
    data = (pathlib.Path(fixture_dir) / entry["file"]).read_bytes()
    if _sha256(data) != entry["sha256"]:
        raise ValueError(f"{entry['file']}: sha256 differs from the manifest")
    return data


def kernel_modules() -> tuple:
    """K1..K6's wrapper modules; each counts its launches in ``launches``."""
    from jpeg_gpu_tpu_torch.ops import (
        entropy_device, idct_float, idct_islow_plane, pack_device, pixel_fused,
        specsync_device,
    )

    return (pixel_fused, entropy_device, specsync_device, pack_device, idct_islow_plane,
            idct_float)


def launch_counts() -> List[int]:
    return [mod.launches for mod in kernel_modules()]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def toolchain(device: torch.device) -> dict:
    """torch, CUDA and nvcc versions and the card; None for what a CPU run lacks."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": None, "gpu": None}
    if device.type == "cuda":
        from jpeg_gpu_tpu_torch import cuda_build

        info["nvcc"] = subprocess.run(
            [cuda_build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True, timeout=60,
        ).stdout.strip().splitlines()[-1]
        info["gpu"] = card_line()
    return info


def _libjpeg_live(data: bytes) -> Optional[np.ndarray]:
    """libjpeg's RGB where this machine's oracle serves it, else None."""
    import jpeg_gpu_tpu_torch as jt

    try:
        return jt.decode(data, impl="libjpeg")
    except jt.JpegUnsupportedError:
        return None


def check_config(data: bytes, entry: dict, device: torch.device) -> dict:
    """The sweep's checks of one committed file on ``device``."""
    import jpeg_gpu_tpu_torch as jt

    ups = entry["upsample"]
    out = jt.decode(data, device=device, upsample=ups)
    host = jt.decode(data, impl="host", upsample=ups)
    dev = jt.decode(data, device=device, entropy="device", upsample=ups)
    rgb_sha = _checksum(out)
    checks = {
        "cuda_eq_host": bool(np.array_equal(out, host)),
        "device_entropy_eq": bool(np.array_equal(dev, out)),
        "rgb_sha_eq_r05": rgb_sha == entry["rgb_sha_r05"],
    }
    if "libjpeg_rgb_sha" in entry:
        checks["eq_libjpeg"] = rgb_sha == entry["libjpeg_rgb_sha"]
        live = _libjpeg_live(data)
        checks["eq_libjpeg_live"] = None if live is None else bool(np.array_equal(out, live))
    if entry["store_xcheck"]:
        checks["raster_eq_xla_store"] = None
    checks["rgb_sha"] = rgb_sha
    return checks


def run(device=None, fixture_dir=FIXTURES) -> dict:
    """Decode every committed sweep file on ``device`` (None: the card, which
    raises without one) and return the artifact: the reference's fields,
    the toolchain, and each config's checks and kernel launches.  A config
    that fails or raises is recorded and counted in ``failed``."""
    from jpeg_gpu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "sweep.run")
    manifest = load_manifest(fixture_dir)
    records = []
    totals = [0] * len(kernel_modules())
    t_start = time.perf_counter()
    for entry in manifest["sweep"]:
        cfg = {k: entry[k] for k in ("i", "h", "w", "q", "mode", "restart", "upsample")}
        before = launch_counts()
        try:
            checks = check_config(read_fixture(fixture_dir, entry), entry, device)
            ok = all(v for k, v in checks.items() if k != "rgb_sha" and v is not None)
        except Exception as e:  # noqa: BLE001 - recorded, counted in "failed"
            checks = {"error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
            ok = False
        counts = [a - b for a, b in zip(launch_counts(), before)]
        totals = [a + b for a, b in zip(totals, counts)]
        records.append({**cfg, **checks,
                        "launches": {f"K{k + 1}": n for k, n in enumerate(counts)}, "ok": ok})
    fails = sum(not r["ok"] for r in records)
    return {
        "n": len(records),
        "n_random": manifest["n_random"],
        "n_pinned": manifest["n_pinned"],
        "seed": manifest["seed"],
        "passed": len(records) - fails,
        "failed": fails,
        "wall_s": time.perf_counter() - t_start,
        "backend": device.type,
        **toolchain(device),
        "launches": {f"K{k + 1}": n for k, n in enumerate(totals)},
        "note": STORE_NOTE,
        "configs": records,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; the CPU only with --device cpu)")
    ap.add_argument("--out", default="SWEEP_torch.json", help="where to write the artifact")
    ap.add_argument("--build-fixtures", metavar="DIR", default=None,
                    help="write the sweep's inputs and manifest into DIR (needs Pillow) "
                         "and exit")
    args = ap.parse_args(argv)
    if args.build_fixtures is not None:
        manifest = build_fixtures(args.build_fixtures)
        print(f"{len(manifest['sweep'])} sweep files and {len(manifest['specsync'])} scan "
              f"inputs -> {args.build_fixtures}")
        return 0
    artifact = run(args.device)
    for r in artifact["configs"]:
        tag = (f"[{r['i']:02d}] {r['h']}x{r['w']} q{r['q']} {r['mode']} r{r['restart']} "
               f"{r['upsample']}")
        print(f"{tag}: {'OK' if r['ok'] else 'FAIL'} {r.get('error', r['launches'])}", flush=True)
    pathlib.Path(args.out).write_text(json.dumps(artifact, indent=1) + "\n")
    print(f"sweep on {artifact['backend']}: {artifact['passed']}/{artifact['n']} OK -> {args.out}")
    return 1 if artifact["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
