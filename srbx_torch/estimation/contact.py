"""Contact estimation and domain-switch logic, batched over lanes.

Counterpart of the debouncer of `srbx/estimation/contact.py`: per leg, a
10-tick history of the thresholded foot force; a leg's estimate latches on
after 10 consecutive contact ticks and off after 10 airborne ones;
touchdown counts toward a domain switch only after phase 0.7; the domain
changes when all four legs' control bits latch. Every field carries a
leading lane axis: (B, 4) per leg, (B,) per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CON_MIN_TIME = 10
HIST_MASK = (1 << CON_MIN_TIME) - 1


class ConState(NamedTuple):
    hist: torch.Tensor          # (B, 4) int32, the last 10 samples
    est: torch.Tensor           # (B, 4) bool, debounced estimate
    rise: torch.Tensor          # (B, 4) bool, left the ground this domain
    stance: torch.Tensor        # (B, 4) bool, latched stance
    ind: torch.Tensor           # (B, 4) int32, control contact index
    ind_prev: torch.Tensor      # (B, 4) int32
    des: torch.Tensor           # (B, 4) int32, desired domain
    change_domain: torch.Tensor  # (B,) bool
    cnt: torch.Tensor           # (B,) int32


def init(bsz: int, des=(1, 1, 1, 1), device=None) -> ConState:
    """`bsz` lanes, all legs in stance. device=None means the CUDA card."""
    device = "cuda" if device is None else device
    des_arr = torch.tensor(des, dtype=torch.int32, device=device).expand(
        bsz, 4).clone()
    ones = torch.ones((bsz, 4), dtype=torch.bool, device=device)
    return ConState(
        hist=torch.full((bsz, 4), HIST_MASK, dtype=torch.int32, device=device),
        est=ones,
        rise=ones.clone(),
        stance=ones.clone(),
        ind=des_arr,
        ind_prev=des_arr.clone(),
        des=des_arr.clone(),
        change_domain=torch.zeros(bsz, dtype=torch.bool, device=device),
        cnt=torch.full((bsz,), 4, dtype=torch.int32, device=device),
    )


def update(state: ConState, force, phase, thresh: float = 8000.0) -> ConState:
    """One 1 kHz tick. force (B, 4) foot force measurements; phase (B,)."""
    con_now = (force > thresh).to(torch.int32)
    hist = ((state.hist << 1) + con_now) & HIST_MASK

    est = torch.where(hist == HIST_MASK, True,
                      torch.where(hist == 0, False, state.est))
    phase_gate = (phase > 0.7)[:, None]
    stance = state.stance | ((state.ind > 0) & state.rise)
    rise = state.rise | ~est
    ctrl = ((rise & est) & phase_gate) | stance
    ind = ctrl.to(torch.int32)
    return ConState(
        hist=hist,
        est=est,
        rise=rise,
        stance=stance,
        ind=ind,
        ind_prev=state.ind,
        des=state.des,
        change_domain=ctrl.all(-1),
        cnt=ind.sum(-1, dtype=torch.int32),
    )


def set_des_domain(state: ConState, des) -> ConState:
    """Start a new domain with stance pattern des (B, 4)."""
    des_arr = des.to(torch.int32)
    return ConState(
        hist=state.hist,
        est=state.est,
        rise=des_arr > 0,
        stance=des_arr > 0,
        ind=des_arr,
        ind_prev=state.ind,
        des=des_arr,
        change_domain=torch.zeros_like(state.change_domain),
        cnt=des_arr.sum(-1, dtype=torch.int32),
    )


def select(mask, new: ConState, old: ConState) -> ConState:
    """Per lane: `new` where mask (B,), else `old`."""
    return ConState(*(torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)),
                                  n, o) for n, o in zip(new, old)))
