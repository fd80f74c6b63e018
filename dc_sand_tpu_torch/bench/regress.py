"""Benchmark regression tracking over a directory of records.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.regress`:
``python -m dc_sand_tpu_torch.bench.regress DIR [--check-verify]``
compares the newest record of each series in ``DIR`` (written by
:meth:`~dc_sand_tpu_torch.bench.harness.BenchResult.save`) with the one
before it and flags drops beyond :data:`TOLERANCE`.

Series are keyed on ``(name, platform, shape)``.  The platform is the
chip and the power limit a card record names (``h100 700.00 W``), so an
H100 row is never compared with a v5e row, nor a card at one power limit
with a card at another, nor either with a CPU run; a benchmark re-run at
another problem shape starts a series of its own.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from collections import defaultdict

__all__ = ["main", "load_results", "implausible", "verify_staleness",
           "TOLERANCE", "VERIFY_SERIES", "KERNEL_PATHS"]

TOLERANCE = 0.10  # flag a throughput drop of more than 10%

# verify records that must exist and postdate the last change to the code
# they verify (filename prefixes in the records directory)
VERIFY_SERIES = ("verify_pfb1k", "verify_pfb4k", "verify_fx4",
                 "verify_fx64", "verify_fx64_production", "verify_beam64")

# paths whose commits invalidate the port's verify records: the ops and
# their kernels, the step composition, the golden oracle, the presets
# and verify itself
KERNEL_PATHS = ("dc_sand_tpu_torch/ops", "dc_sand_tpu_torch/csrc",
                "dc_sand_tpu_torch/models", "dc_sand_tpu_torch/golden",
                "dc_sand_tpu_torch/config.py", "dc_sand_tpu_torch/verify.py")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _git(args, repo_root):
    try:
        r = subprocess.run(["git", *args], capture_output=True, text=True,
                           timeout=15, cwd=repo_root)
        return r.returncode, r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return 1, str(e)


def verify_staleness(results_dir: str, repo_root: str = _REPO,
                     head: str = "HEAD") -> list:
    """Failure messages, one per missing or stale verify series ([] =
    fresh).  A series is stale when a commit in ``record..head`` touches
    :data:`KERNEL_PATHS`, missing when it has no record or the record's
    commit is unknown."""
    failures = []
    for series in VERIFY_SERIES:
        recs = []
        for path in glob.glob(os.path.join(results_dir, series + "_*.json")):
            stem = os.path.basename(path)[len(series) + 1:-len(".json")]
            parts = stem.split("_")
            if len(parts) != 2 or not parts[1].isdigit():
                continue  # a longer series name sharing the prefix
            recs.append((int(parts[1]), parts[0]))
        if not recs:
            failures.append(f"{series}: NO verify record at all")
            continue
        _, commit = max(recs)
        rc, _ = _git(["cat-file", "-e", commit + "^{commit}"], repo_root)
        if rc != 0:
            failures.append(f"{series}: record commit {commit} unknown "
                            "to this repo")
            continue
        rc, out = _git(["log", "--format=%h %s", f"{commit}..{head}",
                        "--", *KERNEL_PATHS], repo_root)
        if rc != 0:
            failures.append(f"{series}: git log failed: {out}")
        elif out:
            touching = out.splitlines()
            failures.append(
                f"{series}: newest record is at {commit} but "
                f"{len(touching)} kernel-path commit(s) postdate it "
                f"(newest: {touching[0]}); verify again")
    return failures


# extra keys that define the measured problem's shape: records of one name
# that differ in any of these are different experiments
_SHAPE_KEYS = ("n_chans", "n_spectra", "n_ants", "n_streams", "n_beams",
               "spectra", "taps", "impl", "mode", "layout", "quant_scale",
               "devices", "cards", "n_blocks", "tb", "m")


def _platform_of(rec: dict) -> str:
    extra = rec.get("extra") or {}
    plat = str(extra.get("chip") or extra.get("platform") or "unknown")
    limit = extra.get("power_limit")
    return f"{plat} {limit}" if limit else plat


def _shape_of(rec: dict) -> str:
    extra = rec.get("extra") or {}
    return ",".join(f"{k}={extra[k]}" for k in _SHAPE_KEYS if k in extra)


def implausible(rec: dict) -> str:
    """Why a record is self-evidently invalid, or '' if it is sane: a
    weak-scaling efficiency above 1.2 (the one-device time was polluted),
    a share of the bound above 1 (a wrong count), a negative value or
    time."""
    extra = rec.get("extra") or {}
    eff = extra.get("efficiency_vs_1dev")
    if eff is not None and eff > 1.2:
        return f"efficiency_vs_1dev={eff:.3g} > 1.2"
    pct = extra.get("pct_of_bound")
    if pct is not None and pct > 1.0:
        return f"pct_of_bound={pct:.3g} > 1"
    if rec.get("value", 0) < 0 or rec.get("wall_s", 0) < 0:
        return "negative value/wall"
    return ""


def load_results(results_dir: str):
    """``(series, rejected)``: the records of ``results_dir`` by ``(name,
    platform, shape)``, each series sorted by the time in its file names,
    and the implausible ones as ``(path, why)``."""
    by_key = defaultdict(list)
    rejected = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        try:
            with open(path) as f:
                rec = json.loads(f.readline())
            ts = int(path.rsplit("_", 1)[1].split(".")[0])
            why = implausible(rec)
            if why:
                rejected.append((path, why))
                continue
            by_key[(rec["name"], _platform_of(rec),
                    _shape_of(rec))].append((ts, rec, path))
        except (ValueError, KeyError, IndexError):
            continue
    for runs in by_key.values():
        runs.sort(key=lambda t: t[0])
    return by_key, rejected


def main(results_dir: str, check_verify: bool = False) -> int:
    """Print each series' newest value against the one before it; returns
    1 on a regression (or, with ``check_verify``, a missing or stale
    verify series), else 0."""
    by_key, rejected = load_results(results_dir)
    for path, why in rejected:
        print(f"REJECTED {os.path.basename(path)}: {why}")
    failed = False
    if check_verify:
        for msg in verify_staleness(results_dir):
            print(f"STALE-VERIFY {msg}")
            failed = True
    if not by_key:
        print(f"no results under {results_dir}")
        return 1 if failed else 0
    for (name, platform, shape), runs in sorted(by_key.items()):
        _, latest, _ = runs[-1]
        label = f"{name} [{platform}]" + (f" ({shape})" if shape else "")
        if len(runs) < 2:
            print(f"{label}: {latest['value']:.4g} {latest['unit']} "
                  "(first recording)")
            continue
        _, prev, _ = runs[-2]
        if prev["value"]:
            ratio = latest["value"] / prev["value"]
        else:
            # no ratio to a zero: 0 -> 0 is unchanged, 0 -> more is a gain
            ratio = 1.0 if not latest["value"] else float("inf")
        mark = "OK"
        if ratio < 1 - TOLERANCE:
            mark = "REGRESSION"
            failed = True
        elif ratio > 1 + TOLERANCE:
            mark = "improved"
        print(f"{label}: {latest['value']:.4g} {latest['unit']} "
              f"({ratio - 1:+.1%} vs prev) [{mark}]")
    return 1 if failed else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results_dir")
    ap.add_argument("--check-verify", action="store_true",
                    help="also fail on a missing or stale verify record")
    args = ap.parse_args()
    sys.exit(main(args.results_dir, args.check_verify))
