"""Gait cycle index tables and phase machinery.

Counterpart of `srbx/gait.py`, numpy only: a gait is a static 4 x M contact
schedule (legs FR, FL, RR, RL x domains), built once as a numpy constant;
schedules are configuration, not tensor data. The campaign reads the trot
schedule (`eval.campaign._contact_table`).
"""

from __future__ import annotations

import functools

import numpy as np

from srbx_torch.config import Gait


def one_cycle_index(gait: Gait) -> np.ndarray:
    """One gait cycle's 4x4 contact pattern (`src/MPC_dist.cpp:887-917`)."""
    cycle = np.ones((4, 4), dtype=np.int32)
    if gait == Gait.WALK:
        # Lift order FR, RL, FL, RR across the four columns.
        cycle[:, 0] = [0, 1, 1, 1]
        cycle[:, 1] = [1, 1, 1, 0]
        cycle[:, 2] = [1, 0, 1, 1]
        cycle[:, 3] = [1, 1, 0, 1]
    elif gait == Gait.TROT:
        leg03 = [0, 1, 1, 0]
        leg12 = [1, 0, 0, 1]
        cycle[:, 0] = leg03
        cycle[:, 1] = leg12
        cycle[:, 2] = leg03
        cycle[:, 3] = leg12
    elif gait == Gait.PACE:
        cycle[:, 0] = [0, 1, 0, 1]
        cycle[:, 1] = [1, 0, 1, 0]
        cycle[:, 2] = [0, 1, 0, 1]
        cycle[:, 3] = [1, 0, 1, 0]
    return cycle


@functools.lru_cache(maxsize=None)
def total_cycle_index(gait: Gait, total_steps: int) -> np.ndarray:
    """Full 4xM schedule: stand column, repeated cycles, optional half cycle.

    Matches `plannedCycleIndex`/`totalCycleIndex`/`totalCycleIndexwHalf`
    (`src/MPC_dist.cpp:857-928`): M = total_steps; the first column and the
    trailing column(s) are all-stance.
    """
    remainder = (total_steps - 2) % 4
    cycles = (total_steps - 2 - remainder) // 4
    cycle = one_cycle_index(gait)
    if remainder == 0:
        table = np.ones((4, 4 * cycles + 2), dtype=np.int32)
        for i in range(cycles):
            table[:, i * 4 + 1 : i * 4 + 5] = cycle
    elif remainder == 2:
        table = np.ones((4, 4 * cycles + 4), dtype=np.int32)
        for i in range(cycles):
            table[:, i * 4 + 1 : i * 4 + 5] = cycle
        table[:, cycles * 4 + 1 : cycles * 4 + 3] = cycle[:, 0:2]
    else:
        raise ValueError(f"total_steps={total_steps}: (M-2) % 4 must be 0 or 2")
    return table


def contact_schedule(gait: Gait, total_steps: int) -> np.ndarray:
    """(M, 4) contact schedule indexed by gait domain (transposed table),
    clamped at the final all-stance column for domains past the schedule."""
    return np.ascontiguousarray(total_cycle_index(gait, total_steps).T)


def phase(loco_tick, dom_ticks):
    """Phase variable s = tick / domain-length (`src/LocoWrapper.cpp:153-157`)."""
    return loco_tick / dom_ticks
