"""Carry state across the two packages.

The system has no learned weights; its state is what a user hands it or
gets back: the NMPC carry (`MpcCarry`) and reference (`RefTraj`), the
whole-body loop's plant (with stick-slip contact its `ContactState`),
agent, contact-estimator and planner states (`SimState`, `AgentState`,
`ConState`, `PlannerState`), its low-level
build's context (`LLCtx`, and `LLCtxR` of the reduced build) and its
result (`LoopResult`), a campaign's result (`CampaignResult`), obstacle fields,
footholds and QP operands; with estimation in the loop the estimator
state (`EstState`: the sensor model's key and biases, the KF's x and P, the
odometry's state, ...). `from_numpy` turns any tree of arrays (numpy, or
anything `np.asarray` accepts, such as the JAX package's arrays) into
tensors, and the JAX package's NamedTuples into the port's of the same name
and fields; a uint32 array, as the JAX package's raw PRNG keys are, becomes
the port's key layout (`srbx_torch.utils.prng`: int64 words). `to_numpy`
is the way back (a key stays int64).
"""

from __future__ import annotations

import numpy as np
import torch

from srbx_torch import agent, lowlevel, motion, mpc, ocp, refplan
from srbx_torch.estimation import contact, kalman, kinest, pipeline
from srbx_torch.eval import campaign
from srbx_torch.ops import qp_batch
from srbx_torch.sim import closedloop, sensors, wholebody
from srbx_torch.utils import prng

_PORT_TYPES = {
    cls.__name__: cls
    for cls in (mpc.MpcCarry, mpc.MpcOutput, refplan.RefTraj, ocp.OcpData,
                wholebody.SimState, wholebody.ContactState, agent.AgentState,
                agent.TickCtx, contact.ConState, motion.PlannerState,
                closedloop.LoopResult, closedloop.EventBatchResult,
                pipeline.EstState, pipeline.EstOut, kalman.KfState,
                kinest.KinEstState, sensors.SensorState, sensors.Reading,
                lowlevel.VcOut, lowlevel.TrajIn,
                lowlevel.LLOut, lowlevel.LLQpData, lowlevel.LLCtx,
                lowlevel.LLCtxR,
                qp_batch.BatchSolution, campaign.CampaignResult)
}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def from_numpy(tree, device=None, dtype=torch.float64):
    """Tree of arrays -> tree of tensors on `device` (None means the CUDA
    card). Floating leaves take `dtype`; integer and boolean leaves keep
    their own type."""
    device = "cuda" if device is None else device
    if tree is None:
        return None
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__, type(tree))
        return cls(*(from_numpy(v, device, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        return prng.as_key(arr, device)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (the port's NamedTuples
    are kept)."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
