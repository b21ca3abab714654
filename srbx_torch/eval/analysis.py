"""Offline analysis of campaign results.

Counterpart of `srbx/eval/analysis.py` (numpy only; the matplotlib plot
`plot_closed_loop` is not ported): summary statistics of a campaign, a
trajectory comparison, solve-time percentiles and a JSON writer. Tensors
and arrays alike are accepted: they are read through numpy.
"""

from __future__ import annotations

import json

import numpy as np


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def campaign_summary(result) -> dict:
    """Success-rate campaign metrics (CampaignResult, possibly batched)."""
    success = _np(result.success)
    min_clear = _np(result.min_clearance)
    fail_d = _np(result.fail_distance)
    finite = np.isfinite(min_clear)
    return {
        "n_scenarios": int(success.shape[0]) if success.ndim > 1 else 1,
        "n_agents": int(success.shape[-1]),
        "success_rate": float(success.mean()),
        "mean_min_clearance": float(np.nanmean(
            np.where(finite, min_clear, np.nan)
        )) if finite.any() else float("nan"),
        "nonfinite_lanes": int((~finite).sum()),
        "failing_distances": fail_d[~success].tolist(),
        "qp_ok_frac": float(_np(result.qp_ok_frac).mean()),
    }


def trajectory_match(traj_a, traj_b) -> dict:
    """Trajectory comparison metrics (the 1e-3 parity check of BASELINE)."""
    a = _np(traj_a).astype(np.float64)
    b = _np(traj_b).astype(np.float64)
    err = np.abs(a - b)
    return {
        "max_abs_err": float(err.max()),
        "rmse": float(np.sqrt((err**2).mean())),
        "within_1e_3": bool(err.max() < 1e-3),
    }


def solve_time_stats(times_s) -> dict:
    """p50/p95/p99 latency summary (replaces SNOPT ms logging,
    `src/MPC_dist.cpp:410-419`)."""
    t = np.sort(_np(times_s).astype(np.float64))
    if t.size == 0:
        return {}
    return {
        "p50_ms": float(1e3 * np.percentile(t, 50)),
        "p95_ms": float(1e3 * np.percentile(t, 95)),
        "p99_ms": float(1e3 * np.percentile(t, 99)),
        "mean_ms": float(1e3 * t.mean()),
        "n": int(t.size),
    }


def dump_json(obj, path: str):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)
