"""Contact estimation and domain-switch logic, batched over lanes.

Counterpart of the debouncer of `srbx/estimation/contact.py`: per leg, a
10-tick history of the thresholded foot force; a leg's estimate latches on
after 10 consecutive contact ticks and off after 10 airborne ones;
touchdown counts toward a domain switch only after phase 0.7; the domain
changes when all four legs' control bits latch. Every field carries a
leading lane axis: (B, 4) per leg, (B,) per lane. Also the module's other
estimators: the probabilistic contact filter (`prob_contact_update`, run by
the estimation pipeline) and the legacy impact detector.
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


def force_domain_change(state: ConState) -> ConState:
    """Flag a domain change on every lane."""
    return state._replace(change_domain=torch.ones_like(state.change_domain))


def impact_detection(phase, total_contact, joint_vel, joint_vel_prev,
                     is_stand, rel_jump: float = 0.02):
    """The legacy impact detector, per lane (B,): an impact when a joint-
    velocity jump exceeds 2 % of the velocity's norm near phase 1, when the
    phase overruns 1.05, or when all four legs touch mid-swing; never while
    standing. joint_vel, joint_vel_prev (B, n)."""
    vel_jump = (torch.linalg.vector_norm(joint_vel - joint_vel_prev, dim=-1)
                > rel_jump * torch.linalg.vector_norm(joint_vel, dim=-1))
    near_end = (phase > 0.95) & (phase <= 1.05)
    impact = (near_end & vel_jump) | ((phase >= 1.05) | (total_contact == 4))
    return impact & ~torch.as_tensor(is_stand, device=impact.device)


def prob_contact_update(p_prev, force, foot_z, phase,
                        f_mid: float = 25.0, f_scale: float = 8.0,
                        z_mid: float = 0.02, z_scale: float = 0.01,
                        trans_stay: float = 0.98):
    """The probabilistic contact estimator: per leg a two-state Bayes
    filter, predicted with a sticky transition toward a gait-phase prior
    (contact likely late in swing) and updated with sigmoid likelihoods of
    the measured normal force and the foot height.

    p_prev, force (N), foot_z (m): (B, 4); phase (B,). Returns (B, 4)
    posterior contact probabilities."""
    p_phase = torch.sigmoid((phase - 0.75) / 0.08)[:, None]
    trans_gain = 1.0 - trans_stay
    p_pred = trans_stay * p_prev + trans_gain * p_phase

    l_force = torch.sigmoid((force - f_mid) / f_scale)
    l_height = torch.sigmoid((z_mid - foot_z) / z_scale)
    like_c = torch.clamp(l_force * l_height, 1e-6, 1.0)
    like_n = torch.clamp((1.0 - l_force) * (1.0 - l_height), 1e-6, 1.0)

    num = p_pred * like_c
    den = num + (1.0 - p_pred) * like_n
    return num / torch.clamp(den, min=1e-12)
