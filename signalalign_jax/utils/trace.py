"""Device metrics from a jax.profiler trace (chip_smoke.py --profile).

A trace directory holds ``plugins/profile/<time>/<host>.xplane.pb``. On a
GPU its ``/device:GPU:<n>`` planes carry one event per kernel, with the
jitted module (``hlo_module``) and execution (``run_id``) as stats. The
reduction is kept here, as code, so that every run computes the same
numbers in the same way:

* busy time: the union of kernel intervals on the device;
* idle share: 1 - busy / window, the window running from the first kernel
  start to the last kernel end;
* per-module kernel time: the sum of kernel durations of each module;
* gaps: the idle stretches between consecutive busy intervals.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]          # (start_ns, end_ns)


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def interval_stats(intervals: Sequence[Interval]) -> Dict[str, float]:
    """Busy/idle figures of one device's kernel intervals (ns in, s out)."""
    if not intervals:
        return {"kernels": 0, "window_s": 0.0, "busy_s": 0.0,
                "idle_share": 1.0, "median_kernel_us": 0.0,
                "median_gap_us": 0.0, "gaps": 0}
    merged = merge_intervals(intervals)
    window = merged[-1][1] - merged[0][0]
    busy = sum(e - s for s, e in merged)
    gaps = [merged[i + 1][0] - merged[i][1] for i in range(len(merged) - 1)]
    return {
        "kernels": len(intervals),
        "window_s": window * 1e-9,
        "busy_s": busy * 1e-9,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "median_kernel_us": float(np.median([e - s for s, e in intervals]))
        * 1e-3,
        "median_gap_us": float(np.median(gaps)) * 1e-3 if gaps else 0.0,
        "gaps": len(gaps),
    }


def device_kernels(trace_dir: str, plane_name: str = "/device:GPU:0"
                   ) -> List[Tuple[str, int, float, float]]:
    """(hlo_module, run_id, start_ns, end_ns) of every kernel on the named
    plane (a GPU; "/host:CPU" for a CPU run) of the newest trace under
    ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    plane = data.find_plane_with_name(plane_name)
    if plane is None:
        raise ValueError(f"trace has no {plane_name} plane")
    out = []
    for line in plane.lines:
        for ev in line.events:
            stats = dict(ev.stats)
            if "hlo_module" not in stats:
                continue            # memcpy/sync markers, not kernels
            out.append((str(stats["hlo_module"]), int(stats.get("run_id", 0)),
                        float(ev.start_ns), float(ev.end_ns)))
    return out


def reduce_trace(trace_dir: str, plane_name: str = "/device:GPU:0") -> Dict:
    """Whole-window idle share plus kernel time per jitted module."""
    kernels = device_kernels(trace_dir, plane_name)
    per_module: Dict[str, float] = defaultdict(float)
    for mod, _, s, e in kernels:
        per_module[mod] += (e - s) * 1e-9
    out = interval_stats([(s, e) for _, _, s, e in kernels])
    out["kernel_s_by_module"] = dict(sorted(per_module.items(),
                                            key=lambda kv: -kv[1]))
    return out


def module_runs(trace_dir: str, module_prefix: str,
                plane_name: str = "/device:GPU:0") -> List[Dict[str, float]]:
    """interval_stats of each execution (run_id) of the modules whose name
    starts with ``module_prefix``, longest window first."""
    runs: Dict[int, List[Interval]] = defaultdict(list)
    for mod, run, s, e in device_kernels(trace_dir, plane_name):
        if mod.startswith(module_prefix):
            runs[run].append((s, e))
    stats = [interval_stats(iv) for iv in runs.values()]
    return sorted(stats, key=lambda st: -st["window_s"])
