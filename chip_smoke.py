#!/usr/bin/env python3
"""Smoke run of srbx_torch on one CUDA card: build, check and time its paths.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Twelve paths, each driven through the entry point a user calls:

* the batched CBF-NMPC control cycle (`srbx_torch.mpc_batch.run_nmpc_batch`
  on its lanes-last fused branch, kernel K1a) at the benchmark operating
  point: B = 131072 lanes, float32, the APF reference of two agents
  (`loop_size` 4000) among 20 random obstacles;
* the whole-body 1 kHz closed loop (`srbx_torch.sim.closedloop.run_batch`:
  the LL QP through kernel K1b, the SPD inverses through K2b, the physics
  solves through K2a, the NMPC at each domain boundary through K1a) at
  B = 4096 lanes, float32: 100 stand-up ticks and the first 50 ticks of
  1 trot domain;
* the NMPC cycle on its generic branch at the reference shape
  (`run_nmpc_batch(backend="pallas", condensed=False)`: QPs of n 41, me 28,
  mi 92 and 112 through the step-fused batched IPM, with the Cholesky and
  Cholesky-solve kernels K3a and K3b on every iteration) at B = 131072,
  float32;
* the template A/B success-rate campaign
  (`srbx_torch.eval.run_campaign_ab.main`: the batched APF planner, then
  120 gait domains of one lanes-last NMPC cycle for all lanes through K1a)
  at the runner's size: 1024 scenarios x 2 agents, 40,000 planner steps,
  float32, QP-only and CBF-SQP, on the JAX package's key-0 fields (drawn
  by the runner through srbx_torch.utils.prng);
* the scenario-batched 4-agent whole-body team
  (`srbx_torch.eval.run_team`, through `closedloop.run_team_batch`) at its
  production point: S 1024 scenarios x 4 agents = 4096 lanes, float32, the
  condensed lanes-last NMPC with the neighbour circle (K1a), the reduced LL
  QP after 5 Ruiz sweeps (K1b at n 25 / me 12), K2a and K2b; 100 stand
  ticks and the first 50 ticks of 1 domain;
* the NMPC cycle on backend "fused" off the benchmark's configuration
  (`run_nmpc_batch(backend="fused")`): uncondensed at the reference shape
  (K1b at n 41 / me 28, mi 92 and 112), condensed with the simplex rows
  kept (K1b at n 17 / me 4) and condensed, simplex-eliminated with the box
  rows kept (K1a at mi 92 and 112), at B = 131072, float32;
* the whole-body loop at `scripts/bench_wholebody.py`'s default batch
  configuration (the uncondensed NMPC through K1b (41, 28), the full LL QP
  through K1b (43, 30)) at B = 4096, float32, 100 stand ticks and the first
  60 ticks of 1 domain;
* estimation in the loop (`closedloop.run_batch(est_cfg=EstConfig())`:
  the controller sees the sensor model's noisy readings through kinematic
  odometry, the noise drawn from the JAX package's keys) at
  `scripts/campaign_wholebody.py`'s batch-r est configuration: B = 4096,
  float32, the condensed lanes-last NMPC (K1a), the reduced LL QP (K1b at
  n 25 / me 12), K2a and K2b; 100 stand ticks and the first 50 ticks of
  1 domain;
* the event-driven loop with estimation (`closedloop.run_batch_event`:
  per-lane contact-triggered domains, an HL poll every 20 ticks, a 20-tick
  latency) at `scripts/campaign_event.py`'s est configuration, B = 4096,
  float32, the same kernels; 100 stand ticks and 200 trot ticks;
* the whole-body loop under trunk pushes with stick-slip contact and the
  CLF row (`closedloop.run_batch(stiction=True, push=...)` with
  `LowLevelConfig(use_clf=True)`) at `scripts/campaign_push.py`'s
  configuration: B = 4096, float32, the QP-only condensed NMPC (K1a), the
  reduced LL QP (K1b at n 25 / me 12), K2a and K2b; every lane pushed at
  (0, 10, ..., 90)[lane % 10] N, the JAX script's key(7) azimuths, from
  trot tick 10; 100 stand ticks and the first 50 ticks of 1 domain;
* the MPC-less velocity-commanded gait WALK
  (`closedloop.run_velocity_gait`: per-lane domains ended by the phase
  overrun or touchdown, the ramped forward command, Raibert steps) at
  `tests/test_wholebody.py`'s configuration: B = 4096, float32, the reduced
  LL QP after 5 Ruiz sweeps (K1b at n 25 / me 12), K2a and K2b, no NMPC;
  300 stand ticks and 250 WALK ticks; and every other gait of the entry
  point (PACE, INPLACE_TROT, INPLACE_WALK, TAP, POSE) in float64 on 64
  lanes;
* the per-agent path, the JAX package's own architecture that its batched
  loops are held to (`closedloop.run` and `closedloop.run_team`: every
  tick `agent.tick`, each agent's LL QP by the dense per-problem IPM
  `ops.qp.solve`, the plant `wholebody.step`, each domain's replan
  `mpc.run_nmpc`; no kernel) at the paper's configuration: two agents,
  float32, `MpcConfig(use_sqp=True, sqp_iters=2)`, `QpConfig()`, the full
  LL build; 100 stand ticks and 1 trot domain of 172 ticks; and in
  float64 `run` and `run_team` against `run_batch` and `run_team_batch`
  on "xla".

Phases, each printing JSON lines (14 runs after 11, before 12; 15 to 19
after 13):

1. probe     - the card, and its name and power limit as nvidia-smi gives;
2. build     - compile every CUDA source in srbx_torch/csrc with nvcc (one
               process per source), report ptxas registers and spills, each
               kernel's resident warps per SM and K2's and K3's launch
               geometry (K1a at mi 28 to 116, K1b at each shape and mi of
               its paths), and fail if any float32 build of K1a, K1b,
               K2a, K2b, K3a or K3b spills;
3. kernel    - K1a against its plain PyTorch version on the card, on the
               cycle's own QPs (mi 28 cold, 48 and 52 warm), in float64
               (strict config) and float32 (relaxed and strict); then, as
               phase "mixed", on B - 5 lanes mixing converging, infeasible
               and one NaN lane in every block, in float64;
4. slice     - the reference planner and one cycle at B = 131072 in float32:
               finite outputs, 3 K1a launches, and the first 512 lanes
               against the plain path in float64;
5. times     - cycles/s (pipelined and synced, relaxed and strict) and K1a's
               time at mi 28, 48 and 52 against the plain version's;
6. wb_kernel - K1b on random well-conditioned QPs of the LL QP's shape
               (float64, to 1e-9) and on LL QPs that the port's tick_build
               makes from stand and trot states at B = 4096 (float64 strict,
               float32 relaxed: converged share and a recomputed stopping
               test), K2a and K2b bitwise on the loop's mass and swing
               matrices;
               then K1b on 4093 mixed lanes as in phase 3;
7. wholebody - run_batch at B = 4096 float32 (100 stand ticks, the
               first 50 of 1 domain): finite, COM height, exact
               launch counts, LL ticks/s; and the first 64 lanes in float64
               through the kernels and through the plain versions (20
               stand, 10 trot ticks: q and COM within 1e-9; in a side
               process, its line after phase 13);
7b. wholebody_uncondensed - run_batch as in 7 with bench_wholebody's
               default MpcConfig (uncondensed: K1b (41, 28) twice a
               domain): finite, COM height, exact launch counts by shape,
               LL ticks/s and the LL-QP ok share;
8. wb_times  - K1b, K2a and K2b at the loop's shapes against their plain
               versions and, for K2, one PyTorch call (library_ms); K2's
               device time from a replayed CUDA graph beside its
               host-inclusive time per call;
9a. k2       - K2a and K2b against their plain versions, bitwise on the
               good lanes, on a ragged batch (B - 3 lanes) of the loop's
               matrices and of random SPD matrices at k 1, 12, 17, 18, 31,
               32 with r 1, 3, k, 32, one lane indefinite (non-finite out,
               the others finite) and NaN above D's diagonal (no change),
               in float64 and float32;
9b. k3       - K3a and K3b against their plain versions, bitwise on the
               good lanes, on random SPD matrices with one indefinite lane,
               at the generic cycle's (k, r), then on a ragged batch
               (B - 3 lanes) at the path's (k, r) and at the edge shapes
               k 1, 33, 64 with r 1, 3, 32, 64, in float64 and float32;
10. generic_cycle - one generic cycle at B = 131072 float32, relaxed and
               strict: finite, exact K3 launch counts, converged share; and
               the first 512 lanes in float64 through the kernels and
               through the plain versions;
11. times    - generic cycles/s (pipelined and synced) and K3a and K3b,
               at each (k, r) the relaxed cycle launched them with, against
               their plain versions and torch.linalg.cholesky_ex /
               torch.cholesky_solve (library_ms); their kernels-line rows
               weight those shapes by their launches;
12. campaign - (a) the batched planner at S 1024, loop 40,000, float32
               (seconds), and 2 fields in float64 against per-field
               rollouts (1e-12); (b) both A/B legs through the runner
               (writes runs/CAMPAIGN_TORCH_1024.json): no non-finite
               lane, success rates within 0.01 of docs/CAMPAIGN_1024.json,
               qp_ok_frac at most 0.005 below it, CBF-SQP above QP-only,
               exact K1a launches; a torch.profiler run of 8 domains a leg
               (the card's busy and idle shares, K1a's share); (c) the
               CBF-SQP leg in float64: success agrees on >= 99 % of lanes;
               (d) K1a against its plain version on the campaign's own QPs
               (domains 60 and 61 of the CBF-SQP leg interleaved, B 2048,
               mi 28 cold and mi 52 warm) in float32 and float64, with its
               ms per launch; (e) the template_campaign golden through K3a
               and K3b (backend "pallas", float64); (f) the CBF-SQP leg at
               S 4096 (domains_per_s);
13. team     - (a) the team at its production point through the runner
               (the JAX script's key(7) fields, loop 20,000): finite,
               LL-QP ok >= 0.99, every LL QP at (25, 12), K1b one launch a
               tick, K1a two a domain, K2a and K2b two a tick;
               robot-ticks/s, the planner's and the loop's seconds, the
               minimum inter-agent
               distance and CBF margin; (b) a torch.profiler run of 5 trot
               ticks (the card's busy and idle shares, K1b's and K2's share)
               and the physics of 5 ticks alone; (c) K1b (25, 12) against
               its plain version: random reduced QPs in float64 (1e-9,
               equal flags and iterations), the loop's own reduced QPs after
               Ruiz in float64 (the same) and float32 (converged share
               within 0.5 points, max |d tau| reported), 4093 mixed lanes
               as phase "mixed", and its ms per launch; (d) the team golden
               through K3a/K3b, K2a/K2b (backend "pallas", float64) at the
               golden's bounds: its planner here, its loop in a side
               process, its line after phase 16.

14. nmpc_fused - (a) K1b at (41, 28) (mi 92, 112, 116) and (17, 4) (mi 28,
               48, 52, 92, 112, 116) on 4093 random well-conditioned QPs,
               K1a at mi 92, 112, 116 on 16379, float64 (1e-9, equal flags
               and per-lane iterations), with resident warps; (b) each on
               mixed ragged lanes at mi 116 as phase "mixed"; (c) each on
               the NMPC's own QPs (cold, SCP, SCP with the neighbour
               circle), float64 strict and float32 relaxed, trajectories and
               converged shares against the plain version, and K1a through
               qp_fused.solve at me = 0; (d) ms per launch against the plain
               version on those QPs, float32, B = 131072 (K1b (41, 28) at
               B = 4096 too), with bounds; (e) the uncondensed cycle on
               "fused" at B = 131072, relaxed and strict: finite, exactly
               1 + sqp_iters K1b launches at (41, 28), converged share, the
               first 512 lanes in float64 against the plain version, and
               cycles/s beside phase 11's "pallas" cycle; (f) one cycle each
               of the (17, 4) and the box-rows-kept K1a configurations:
               exact launches, finite, cycles/s.

15. est_loop - run_batch with estimation in the loop (est_key key(11)) at
               B = 4096 float32: finite, every lane standing (final COM z >
               0.2 m), LL qp_ok >= 0.99, est RMSE <= 20 mm and <= 0.1 m/s
               on every lane, exact launch counts; LL ticks/s; a profile of
               5 trot ticks (the card's idle share) and the estimator's
               host ms a tick (the PRNG, the sensors, the KF, kinEst, the
               whole pipeline.update); the first 64 lanes in float64
               through the kernels and the plain versions (q, COM and est
               RMSE within 1e-9);
16. event    - run_batch_event with estimation at B = 4096 float32: every
               lane kicked off at tick 0 and ending a contact-triggered
               domain of 121-180 ticks, finite, standing, LL qp_ok >=
               0.95, exact launch counts (K1a two an HL poll); LL ticks/s,
               domains and solves per lane, contact against time triggers,
               est RMSE; the first 64 lanes in float64 through the kernels
               and the plain versions (trigger ticks, domains and solves
               equal, q, COM and est RMSE within 1e-9).
17. disturbance - run_batch with stiction, the CLF row and a push on every
               lane at B = 4096 float32: on the lanes at or under 30 N
               finite, standing, LL qp_ok >= 0.9; exact launch counts; LL
               ticks/s, slip p50 and max, success against magnitude (the
               push campaign's rule); a profile of 5 trot ticks (the card's
               idle share); in the side processes the first 64 lanes in
               float64 through the kernels and the plain versions (10
               stand, 10 trot ticks, pulses from trot tick 2: q, COM and
               slip within 1e-9, equal qp_ok) and at the phase's depth
               (slip against float32), and a CLF-on/CLF-off pair
               without push or stiction, 64 lanes, in float64 at
               scripts/campaign_clf.py's configuration (the COM distance
               beside docs/CLF_LOOP.json's 1.47e-7 m) and in float32 at
               the phase's (the LL qp_ok shares).
18. velocity_gait - run_velocity_gait(WALK) at B = 4096 float32
               (MotionConfig(fwd_speed=0.15), the JAX test's relaxed
               solver): finite, COM z > 0.25 m over the WALK ticks and LL
               qp_ok >= 0.95 on every lane, domains >= 2 on every lane,
               every LL QP at (25, 12), exact launch counts (K1b once a
               tick, K2a and K2b twice, no K1a or K3); LL ticks/s, the x
               advance, a profile of 5 WALK ticks (the card's idle share);
               in the side processes every gait (WALK, PACE, INPLACE_TROT,
               INPLACE_WALK, TAP on "pallas", POSE; INPLACE_TROT and TAP
               with the full build) in float64 on the first 64 lanes,
               10 stand and 15 gait ticks, through the kernels and the
               plain versions: q and COM within 1e-9, equal qp_ok and
               domains, POSE's domains <= 1.
19. per_agent - (a) in a side process, float64: `closedloop.run` (one
               agent, tests/test_wholebody.py:165-199's configuration, 100
               stand and 2 x 40 trot ticks) against run_batch("xla") at
               B 1 (q and COM within 1e-8, qp_ok and mpc_ok within 1e-12)
               and `run_team` (two agents, tests/test_team.py:50-100's, 100
               + 2 x 30) against run_team_batch("xla") at S 1 (COM within
               2e-3, margins within 1e-2, LL qp_ok > 0.95); (b) run_team at
               the paper's configuration (tests/test_team.py:15-48), two
               agents, float32, 100 + 1 x 172 ticks: no kernel launched,
               both agents finite and standing (|z - 0.28| < 0.03 m, roll
               and pitch < 0.15 rad), every CBF margin >= cbf_eps - 1e-3;
               LL qp_ok >= 0.85 (in float32 under QpConfig() the LL QP's
               IPM meets a non-finite step on some ticks, in the JAX
               package too, which converges 0.860 of them here; 0.95 is
               held in float64); ms a tick, the IPM iterations of the NMPC's and
               the LL's QPs, the final separation; a profile of 5 trot
               ticks (the card's idle share).

The team golden's loop and the float64 runs of phases 7 and 15-18 (and
the float32 CLF pair) go on in five side processes (SIDE_GROUPS), started
after phase 13 and run beside phases 15 and 16, whose rates they slow;
phase 19's float64 runs go on in a sixth, started with them. All six end
before phase 17, which waits for them; a "side_processes" line gives each
one's seconds and the wait. Phases 3-14 and 17-19 run alone on the card.

Then a {"kernels": [...]} line (K1b (41, 28), K1b (17, 4) and K1a above
64 rows on rows of their own; each row's launches by path include phases
15-19's, phase 19's 0 on every row) and, last, {"ok": true, "device":
{...}}.
Any failed check raises and the script exits non-zero. Without a CUDA card,
or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 131072
CROSS_LANES = 512
REPS = 10
GEN_REPS = 3             # generic-cycle repetitions per timing
WB_BATCH = 4096          # whole-body lanes
WB_CROSS_LANES = 64      # whole-body lanes run in float64, kernels vs plain
WB_CROSS = (20, 1, 10)   # the whole-body phase's float64 run: its depth
CAMPAIGN_LOOP = 40_000   # the A/B runner's APF rollout steps
SCALING_SCENARIOS = 4096  # the campaign's scaling line
WB_DEPTH = (100, 1, 50)     # the whole-body loop: stand, domains, ticks
TEAM_SCENARIOS = 1024    # the team phase: S x 4 agents = 4096 lanes
TEAM_DEPTH = (100, 1, 50)   # its stand ticks, domains and ticks a domain
EST_DEPTH = (100, 1, 50)    # estimation in the loop: stand, domains, ticks
EVENT_DEPTH = (100, 200)    # the event-driven loop: stand and trot ticks
EST_CROSS = (10, 1, 10)     # their float64 kernels-vs-plain runs, 64 lanes:
EVENT_CROSS = (10, 165)     # a contact trigger near tick 160
DIST_DEPTH = (100, 1, 50)   # the disturbance phase: stand, domains, ticks
DIST_PUSH = (10, 300)       # its pulses' first trot tick and duration
DIST_CROSS = (10, 1, 10)    # its float64 kernels-vs-plain run, 64 lanes,
DIST_CROSS_PUSH = (2, 300)  # pulses from trot tick 2
CLF_PAIR = (150, 1, 80)     # the CLF-on/CLF-off pair, 64 lanes
VEL_DEPTH = (300, 250)      # the velocity-gait phase: stand and WALK ticks
VEL_CROSS = (10, 15)        # each gait's float64 kernels-vs-plain run, 64
# lanes: gait -> (backend, reduced LL build); the full build's K1b (43, 30)
# and, on "pallas", K3a and K3b run through the gait branches too
VEL_FORMS = {"WALK": ("fused", True), "PACE": ("fused", True),
             "INPLACE_TROT": ("fused", False), "INPLACE_WALK": ("fused", True),
             "TAP": ("pallas", False), "POSE": ("fused", True)}
# the per-agent path (phase 19): stand ticks, domains, ticks a domain
AGENT_RUN = (100, 2, 40)    # run vs run_batch("xla"), float64, one agent
#                             (tests/test_wholebody.py:165-199: 200 stand)
AGENT_TEAM = (100, 2, 30)   # run_team vs run_team_batch("xla"), float64,
#                             two agents (tests/test_team.py:50-100: 150)
AGENT_PAPER = (100, 1, 172)  # run_team at the paper's configuration, f32
AGENT_PROFILE_TICKS = 5     # trot ticks profiled after it
# its LL qp_ok floor in float32: under QpConfig() (shifts of 1e-9) the LL
# QP's IPM meets a non-finite step on some ticks; the JAX package's own
# float32 run at this configuration and depth converges 0.860 of its LL
# QPs on an x86 CPU and the port 0.863 there (tests/test_torch_per_agent.py,
# the slow float32 test), 0.892 on the H100, so the floor sits just under
# both readings; the JAX test's 0.95 holds in float64 (the side jobs,
# scripts/torch_per_agent_depth.py)
AGENT_F32_LL_OK = 0.85
NMPC_CHECK_LANES = 16384  # lanes of the NMPC's own QPs held to K1's plain
K1_NEW_REPS = 3          # K1b launches per timing at B = 131072
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores


_START = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def stopping_test(data, sol):
    """The IPM's relative residual and gap, recomputed in float64 from a
    returned (x, y, z, s) (batch-leading; me may be 0), and the gap test's
    scale 1 + |objective|."""
    P, c, A, b, G, h = (t.double() for t in data)
    x, y, z, s = (t.double() for t in (sol.x, sol.y, sol.z, sol.s))

    def mv(m, v):
        return torch.einsum("bij,bj->bi", m, v)

    def mtv(m, v):
        return torch.einsum("bij,bi->bj", m, v)

    def amax(*ts):
        return torch.stack([t.abs().amax(1) for t in ts
                            if t.shape[1]]).amax(0)

    px, gx, ax, gtz, aty = mv(P, x), mv(G, x), mv(A, x), mtv(G, z), \
        mtv(A, y)
    res = torch.maximum(
        amax(px + c + gtz + aty) / amax(px, c, gtz, aty).clamp(min=1.0),
        amax(gx + s - h, ax - b) / amax(gx, h, ax, b).clamp(min=1.0))
    obj = 0.5 * (x * px).sum(1) + (c * x).sum(1)
    return res, (s * z).sum(1), 1.0 + obj.abs()


def certify(data, sol, qp_cfg, slack):
    """Whether each lane that `sol` calls converged meets the stopping test
    recomputed in float64 (`stopping_test`) within `slack`, and the largest
    recomputed residual of those lanes."""
    res, gap, gap_scale = stopping_test(data, sol)
    conv = sol.converged
    ok = ((res <= (qp_cfg.abstol + qp_cfg.reltol) * slack)
          & (gap <= qp_cfg.abstol * gap_scale * slack))[conv]
    return (ok.double().mean().item() if conv.any() else 1.0,
            res[conv].max().item() if conv.any() else 0.0)


def ipm_flops(n, me, mi, refine, lane_iters, cold):
    """Floating-point operations (leading terms, a multiply-add counted as
    2) that the fused IPM needs for lanes whose iteration counts are
    `lane_iters` (a tensor of the run's own counts): the start, then per
    iteration the factorization of M = P + G'WG (and of S = A M^-1 A' with
    M^-1 A' when me > 0), two refined KKT solves with their right-hand
    sides and step directions, and the residual test."""
    chol = lambda k: k ** 3 / 3                            # noqa: E731
    factor = mi * n * (n + 1) + chol(n)
    if me:
        factor += 2 * n * n * me + me * (me + 1) * n + chol(me)
    kkt = 2 * n * n + (4 * me * n + 2 * me * me if me else 0)
    refine_step = 4 * mi * n + 2 * n * n + (4 * me * n if me else 0) + kkt
    conv = 4 * mi * n + 2 * n * n + (4 * me * n if me else 0)
    per_iter = (factor + 2 * (kkt + refine * refine_step)
                + 2 * 4 * mi * n + conv)
    start = (factor + kkt + 2 * mi * n) if cold else 0
    lanes = lane_iters.numel()
    return lanes * (start + 2 * mi * n + conv) + per_iter * float(
        lane_iters.double().sum())


def bound(nbytes, flops):
    """The least time the card could take: bytes moved once over the HBM
    rate against float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def k3_work(k, r, bsz, itemsize=4):
    """Bytes that K3a (r = 0) or K3b (r right-hand sides) must move on bsz
    lanes, and the operations it does: the lower triangle of M or L read once
    (k (k + 1) / 2 entries: nothing needs the rest), L (k x k, its zeros
    included) or X written once, the right-hand sides read once; k^3 / 3
    operations for the factorization, 2 k^2 r for the two substitutions."""
    tri = k * (k + 1) // 2
    if r == 0:
        return itemsize * bsz * (tri + k * k), bsz * k ** 3 / 3
    return itemsize * bsz * (tri + 2 * k * r), bsz * 2 * k * k * r


def k2_work(k, r, bsz, identity, itemsize=4):
    """Bytes that K2a (r right-hand sides) or K2b (identity: the inverse,
    r = k) must move on bsz lanes, and the operations it does: the lower
    triangle of D read once (k (k + 1) / 2 entries: nothing needs the rest),
    the right-hand sides read once (none for the identity) and X written
    once; k^3 / 3 operations for the factorization and 2 k^2 r for the two
    substitutions, of which the identity's forward pass needs only the rows
    at and below each column's one (k^3 / 3 in all)."""
    tri = k * (k + 1) // 2
    nbytes = itemsize * bsz * (tri + (0 if identity else k * r) + k * r)
    subst = k ** 3 / 3 + k ** 3 if identity else 2 * k * k * r
    return nbytes, bsz * (k ** 3 / 3 + subst)


def spd_inputs(bsz, dtype, seed, dev):
    """The whole-body loop's SPD operands, made on the card from `seed`:
    "d18", A1 mass matrices (bsz, 18, 18) at random configurations (joint
    angles and base pose N(0, 0.4)); "d12", the swing operational-space
    matrices (bsz, 12, 12) built from them as the low-level build does, with
    random stance flags; "rhs18", right-hand sides (bsz, 18), N(0, 10)."""
    from srbx_torch.lowlevel import LLCtx, swing_delta_inv
    from srbx_torch.models import a1, rbd
    from srbx_torch.ops import spd

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = a1.model()
    q = 0.4 * torch.randn(bsz, 18, generator=gen, device=dev, dtype=dtype)
    d = rbd.mass_matrix(model, q).contiguous()
    toe_jac = rbd.site_jacobians(model, q)[:, a1.TOE_SITES]
    con = torch.randint(0, 2, (bsz, 4), generator=gen, device=dev).to(dtype)
    zero = torch.zeros(bsz, dtype=dtype, device=dev)
    ctx = LLCtx(spd.inverse_plain(d), None, None, None, toe_jac, None, con,
                zero, zero, None, zero)
    return {"d18": d, "d12": swing_delta_inv(ctx).contiguous(),
            "rhs18": 10.0 * torch.randn(bsz, 18, generator=gen, device=dev,
                                        dtype=dtype)}


def k2_checks(spd, dev, lanes, bad_lane=7):
    """K2a and K2b against `solve_plain` and `inverse_plain` on `lanes`
    lanes, in float64 and float32: on the loop's matrices (`spd_inputs`:
    the solve at k 18, r 1 and the inverses at k 18 and 12) and on random
    well-conditioned SPD matrices at k 1, 12, 17, 18, 31 and 32 (the solve
    at r 1, 3, k and 32, and the inverse). In every case lane `bad_lane` is
    made indefinite (a diagonal entry -1) and must come out non-finite; every
    other lane must be finite and bitwise equal to the plain version's; and
    NaN written above D's diagonal must change no lane. Returns the records
    and the wrappers' calls, {"K2a": n, "K2b": m}."""
    gen = torch.Generator(device=dev).manual_seed(13)
    records, calls = [], {"K2a": 0, "K2b": 0}
    good = torch.ones(lanes, dtype=torch.bool, device=dev)
    good[bad_lane] = False
    for dtype in (torch.float64, torch.float32):
        loop = spd_inputs(lanes, dtype, 5, dev)
        cases = [("loop", loop["d18"], [loop["rhs18"]]),
                 ("loop", loop["d12"], [])]
        for k in (1, 12, 17, 18, 31, 32):
            a = torch.randn(lanes, k, k, generator=gen, device=dev,
                            dtype=dtype)
            d = a @ a.mT / k + torch.eye(k, dtype=dtype, device=dev)
            rhs = [torch.randn(lanes, k, generator=gen, device=dev,
                               dtype=dtype)]
            rhs += [torch.randn(lanes, k, r, generator=gen, device=dev,
                                dtype=dtype) for r in sorted({3, k, 32})
                    if r > 1]
            cases.append(("random", d, rhs))
        for source, d, rhss in cases:
            k = d.shape[-1]
            d = d.clone()
            d[bad_lane, k // 2, k // 2] = -1.0
            upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
            d_nan = d.masked_fill(upper, float("nan"))
            runs = [("K2b", None, spd.inverse, spd.inverse_plain, ())]
            runs += [("K2a", 1 if b.dim() == 2 else b.shape[2], spd.solve,
                      spd.solve_plain, (b,)) for b in rhss]
            for kernel, r, fn, plain, extra in runs:
                got = fn(d, *extra)
                got_nan = fn(d_nan, *extra)
                want = plain(d, *extra)
                torch.cuda.synchronize()
                calls[kernel] += 2
                rec = {"phase": "k2", "kernel": kernel, "case": source,
                       "dtype": str(dtype), "lanes": lanes, "k": k, "r": r,
                       "bad_lane": bad_lane,
                       "max_abs_err": (got[good] - want[good]).abs().max()
                       .item(),
                       "bitwise_equal": bool(torch.equal(got[good],
                                                         want[good])),
                       "bad_lane_nonfinite": not bool(
                           torch.isfinite(got[bad_lane]).all()),
                       "other_lanes_finite": bool(
                           torch.isfinite(got[good]).all()),
                       "upper_nan_changes_nothing": bool(
                           torch.equal(got_nan[good], got[good])
                           and not torch.isfinite(got_nan[bad_lane]).all()),
                       "bound": ("bitwise equal to the plain version on "
                                 "every other lane; the indefinite lane "
                                 "non-finite, every other lane finite; NaN "
                                 "above D's diagonal changes no lane")}
                rec["ok"] = (rec["bitwise_equal"] and rec["bad_lane_nonfinite"]
                             and rec["other_lanes_finite"]
                             and rec["upper_nan_changes_nothing"])
                records.append(rec)
    return records, calls


def k1a_work(P, c, G, h, x0, lane_iters, refine, itemsize=4):
    """Bytes that K1a must move (P, c, G, h and x0 read once; x, z, s and
    stat written once) and the operations its lanes' iterations need."""
    n, bsz = c.shape
    mi = G.shape[0]
    read = P.numel() + c.numel() + G.numel() + h.numel() + (
        0 if x0 is None else x0.numel())
    nbytes = itemsize * (read + (n + 2 * mi + 8) * bsz)
    return nbytes, ipm_flops(n, 0, mi, refine, lane_iters, cold=x0 is None)


def k1b_work(data, sol, refine, itemsize=4):
    """Bytes that K1b must move (P, c, A, b, G, h read once; x, y, z, s and
    stat written once) and the operations its lanes' iterations need (the
    regularised KKT start included)."""
    P, c, A, b, G, h = data
    bsz, n = c.shape
    nbytes = itemsize * (sum(t.numel() for t in data) + sum(
        t.numel() for t in (sol.x, sol.y, sol.z, sol.s)) + 8 * bsz)
    return nbytes, ipm_flops(n, A.shape[1], G.shape[1], refine,
                             sol.lane_iters, cold=True)


def make_mixed(G, h, every=16, first=3, nan_lane=7):
    """Mix lanes that stop at different iterations into every block, in
    place, on batch-leading views G (B, mi, n) and h (B, mi): lanes first,
    first + every, ... get the contradictory rows x_0 <= -1 and -x_0 <= -1
    (infeasible: they run to max_iters), and lane nan_lane gets h = NaN in
    its first row (non-finite from its start: the NaN freeze stops it at
    its first iteration). The other lanes converge in a few iterations.
    Returns the infeasible lanes."""
    idx = torch.arange(first, G.shape[0], every, device=G.device)
    G[idx, :2] = 0.0
    G[idx, 0, 0] = 1.0
    G[idx, 1, 0] = -1.0
    h[idx, :2] = -1.0
    h[nan_lane, 0] = float("nan")
    return idx


def mixed_record(kernel, lanes, xk, xp, fin_k, fin_p, conv_k, conv_p,
                 it_k, it_p, infeasible, nan_lane, max_iters):
    """Kernel against plain version on a ragged batch of mixed lanes (x
    batch-leading, per-lane finiteness, converged flags and iterations)."""
    both = conv_k & conv_p
    nonfinite = torch.nonzero(~fin_k).flatten().tolist()
    rec = {"lanes": lanes, "dtype": "float64", "max_iters": max_iters,
           "max_abs_dx_converged": (xk[both] - xp[both]).abs().max().item(),
           "converged_kernel": conv_k.double().mean().item(),
           "converged_equal": bool((conv_k == conv_p).all()),
           "lane_iters_equal": bool((it_k == it_p).all()),
           "finite_equal": bool((fin_k == fin_p).all()),
           "nonfinite_lanes_kernel": nonfinite,
           "iters_min": it_k.min().item(), "iters_max": it_k.max().item(),
           "infeasible_lanes_at_max_iters": bool(
               (it_k[infeasible] == max_iters).all()),
           "bound": ("lanes converged in both: max|dx| <= 1e-9; equal "
                     "converged flags, per-lane iterations and finiteness; "
                     "only the NaN lane non-finite; iterations span 1 to "
                     "max_iters")}
    rec["ok"] = (rec["max_abs_dx_converged"] <= 1e-9
                 and rec["converged_equal"] and rec["lane_iters_equal"]
                 and rec["finite_equal"] and nonfinite == [nan_lane]
                 and rec["iters_min"] == 1 and rec["iters_max"] == max_iters
                 and rec["infeasible_lanes_at_max_iters"])
    emit({"phase": "mixed", "kernel": kernel, **rec})
    check(rec["ok"], f"{kernel} on mixed ragged lanes: {rec}")


def ptxas_summary(log: str, kernel: str):
    """Registers, stack bytes and spill bytes of every instantiation of
    `kernel` in an `nvcc -Xptxas -v` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or kernel not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.append({"entry": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["entry"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def event_ms(fn, reps):
    """Mean CUDA-event time in ms of `reps` back-to-back calls of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches=100, replays=3):
    """Device time in ms per call of fn: a CUDA graph of `launches` calls,
    captured once and replayed `replays` times between CUDA events, one
    value per replay. The host does no work between the launches, so this
    is the card's time (the gaps between a graph's kernels included), not
    the wrapper's. The captured calls run once each, in the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    del graph
    torch.cuda.empty_cache()
    return out


def profiler_ms(fn, name="", calls=20):
    """CUDA time in ms per call of fn spent in the kernels whose name holds
    `name` (every kernel, by default), from torch.profiler over `calls`
    calls (device_profile): the kernels' own time, without the gaps between
    them; None where the profiler records no device time for them. (A
    library call that synchronises or allocates inside cannot be captured
    in a CUDA graph; this times it on the device all the same.)"""
    fn()
    _, _, by_name = device_profile(lambda: [fn() for _ in range(calls)])
    total = sum(ms for key, ms in by_name.items() if name in key)
    return total / calls if total > 0 else None


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(rec):
    """One JSON line; records of a phase carry the seconds since start."""
    if "phase" in rec:
        rec = dict(rec, elapsed_s=time.perf_counter() - _START)
    print(json.dumps(rec), flush=True)


def benchmark_inputs(dev):
    """The benchmark's reference and lanes (bench.py): the planner runs on
    the card in float32; the lanes are made with numpy, as the JAX
    package's inputs would be. Returns (inputs, p_start, pobs)."""
    from srbx_torch import convert, mpc, refplan
    from srbx_torch.ocp import default_footholds

    f32 = torch.float32
    p_start = np.array([0.0, 0.5, 0.0, -0.5])
    pobs = np.stack([np.random.default_rng(0).uniform(2.0, 8.0, 20),
                     np.random.default_rng(1).uniform(-2.0, 2.0, 20)])
    ref = convert.to_numpy(refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(pobs, dtype=f32, device=dev), dtype=f32, device=dev))
    check(bool(np.isfinite(ref.pr).all() and np.isfinite(ref.prd).all()),
          "refplan.generate gave non-finite knots")
    agent0 = p_start[:2]
    q = agent0 + np.linspace(0, 0.01, BATCH)[:, None]
    zeros = np.zeros(BATCH)
    inputs = (
        mpc.MpcCarry(np.zeros(BATCH, np.int32),
                     np.stack([q[:, 0], zeros, q[:, 1], zeros], 1)),
        q, np.zeros((BATCH, 2)),
        np.tile(default_footholds(torch.tensor(agent0)).numpy(), (BATCH, 1, 1)),
        np.tile([0.0, 1.0, 1.0, 0.0], (BATCH, 1)),
        np.tile(ref.pr[0:2], (BATCH, 1, 1)), np.tile(ref.prd[0:2], (BATCH, 1, 1)),
        np.tile(agent0, (BATCH, 1)), np.tile(pobs, (BATCH, 1, 1)),
    )
    return inputs, p_start, pobs


def lanes_of(inputs, dev, dtype, count=BATCH):
    """The first `count` benchmark lanes on the card in `dtype`."""
    from srbx_torch import convert, mpc

    carry, *rest = inputs
    head = (mpc.MpcCarry(*(a[:count] for a in carry)),
            *(a[:count] for a in rest))
    return convert.from_numpy(head, dev, dtype)


def cycle_qps(cfg, qp_cfg, lanes, other, scp_masks, cold="cold_mi28"):
    """The cycle's own QPs on `lanes` (run_nmpc_batch's lane arguments,
    carry first): the cold first solve (mi 28), then for each (case, mask)
    in `scp_masks` an SCP solve as the cycle's first round builds it, warm
    from the first solve's plain solution under qp_cfg: the velocity rows
    and the linearised CBF rows of the closest obstacle and, with a second
    mask entry, of `other` (B, 2), the neighbour, masked as the cycle masks
    it (mi 48 with one circle, 52 with two). Returns the condensed QP and
    [(case, G, h, x0)]."""
    from srbx_torch import mpc, mpc_batch, sqp
    from srbx_torch.ocp import contract
    from srbx_torch.ops import qp_fused

    carry, q, dq, toe, ci, pr, prd, a0, pob = lanes
    dtype, bsz = q.dtype, q.shape[0]
    ci_eff = mpc_batch.effective_contacts(carry, ci)
    qp = mpc_batch.condensed_qp(cfg, carry, q, dq, toe, ci_eff, pr, prd, a0)
    x_ll = qp_fused.solve_lanes_last_plain(qp.P, qp.c, qp.G, qp.h,
                                           qp_cfg)[0]
    x = mpc_batch.expand_ll(qp, x_ll)
    x0 = contract(cfg, x, ci_eff).T.contiguous()
    circles = torch.stack([mpc.closest_obstacle(q, pob)[0], other], 1)
    vel_g, vel_h = sqp._vel_rows(cfg, dtype, q.device)
    cases = [(cold, qp.G, qp.h, None)]
    for name, mask in scp_masks:
        m = torch.tensor(mask, dtype=dtype, device=q.device).expand(
            bsz, len(mask))
        cbf_g, cbf_h = sqp._cbf_rows(cfg, x, circles[:, :len(mask)], m,
                                     dtype)
        g, h = mpc_batch.project_rows(
            qp, torch.cat([vel_g.expand(bsz, -1, -1), cbf_g], 1),
            torch.cat([vel_h.expand(bsz, -1), cbf_h], 1))
        cases.append((name, g, h, x0))
    return qp, cases


def nmpc_cycle_qps(cfg, strict, inputs, p_start, pobs, dev, dtype):
    """The benchmark cycle's own QPs (`cycle_qps` on the benchmark lanes):
    the cold first solve (mi 28), and SCP solves warm-started from its
    solution with one (mi 48) and two (mi 52) CBF circles, the second the
    other agent's start. `pobs` is the lanes' own field (kept for the
    scripts that call this)."""
    other = torch.tensor(p_start[2:], dtype=dtype,
                         device=dev).expand(BATCH, 2)
    return cycle_qps(cfg, strict, lanes_of(inputs, dev, dtype), other,
                     (("warm_mi48", (1.0,)), ("warm_mi52", (1.0, 1.0))))


def random_ll_qps(bsz, dev, dtype, seed=7, n=43, me=30, mi=45):
    """Random QPs at the LL QP's shape, well conditioned (diagonal P in
    [0.1, 10], a strictly feasible point), made with numpy from a seed:
    [P, c, A, b, G, h] batch-leading."""
    rng = np.random.default_rng(seed)
    p = np.zeros((bsz, n, n))
    p[:, np.arange(n), np.arange(n)] = rng.uniform(0.1, 10.0, (bsz, n))
    a = rng.normal(size=(bsz, me, n))
    g = rng.normal(size=(bsz, mi, n))
    x_feas = rng.normal(size=(bsz, n))
    return [torch.tensor(v, dtype=dtype, device=dev) for v in (
        p, rng.normal(size=(bsz, n)), a, np.einsum("bmn,bn->bm", a, x_feas),
        g, np.einsum("bmn,bn->bm", g, x_feas)
        + rng.uniform(0.1, 1.0, (bsz, mi)))]


def device_profile(fn):
    """Wall seconds of fn (ended by a synchronize) under torch.profiler, the
    card's busy ms in it (the kernels' and copies' own time) and the busy
    ms by kernel name. The profiler's own host cost is in the wall."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's events summed straight from the trace: building the
    # profiler's event tree (events(), key_averages()) for every host op
    # takes tens of seconds for a few whole-body ticks
    by_name = {}
    for evt in prof.profiler.kineto_results.events():
        if (evt.device_type() == torch.autograd.DeviceType.CUDA
                and not evt.is_async()):
            ms = (evt.end_ns() - evt.start_ns()) / 1e6
            if ms > 0:
                by_name[evt.name()] = by_name.get(evt.name(), 0.0) + ms
    return wall, sum(by_name.values()), by_name


def campaign_golden_check(dev, smi):
    """The template_campaign golden (docs/golden/golden.json) on the card:
    backend "pallas" (K3a and K3b), float64, the golden's uncondensed
    configuration, QpConfig(), 8 domains, loop 4000, on the JAX package's
    key-1234 fields. Its bounds are the golden's own, but for final_xy on
    the lanes where some QP of the run does not converge, held to the JAX
    package's 3e-2 for the SCP's amplification of rounding (the same lanes
    run to max_iters in both packages; tests/test_torch_golden.py)."""
    from srbx_torch import refplan
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.eval import campaign, run_campaign_ab
    from srbx_torch.ops import pallas_linalg as plin, qp_batch, qp_fused
    from srbx_torch.utils import prng

    with open(ROOT / "docs" / "golden" / "golden.json") as f:
        gold = json.load(f)["template_campaign"]
    f64 = torch.float64
    pobs, pobs_real = campaign.sample_obstacles(
        prng.split(prng.key(1234, dev))[0], 32, 20, 0.6, f64, dev)
    unconverged = torch.zeros(pobs.shape[0] * 2, dtype=torch.bool,
                              device=dev)
    real_solve = qp_batch.solve

    def watched(*a, **kw):
        sol = real_solve(*a, **kw)
        unconverged.logical_or_(~sol.converged)
        return sol

    counters = (plin.batch_cholesky, plin.batch_cho_solve,
                qp_fused.solve_lanes_last, qp_fused.solve)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(qp_batch, "solve", watched):
        res = campaign._run_campaign_batch_core(
            MpcConfig(use_sqp=True, sqp_iters=2), QpConfig(),
            campaign.CampaignConfig(n_agents=2, n_domains=8),
            refplan.two_agent_config(loop_size=4_000),
            torch.tensor(run_campaign_ab.P_START, dtype=f64, device=dev),
            pobs, pobs_real, None, "pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in zip(
        ("K3a", "K3b", "K1a", "K1b"), counters)}
    got = {k: v.cpu().numpy() for k, v in res._asdict().items()}
    ok_lanes = ~unconverged.reshape(-1, 2).cpu().numpy()
    d_final = np.abs(got["final_xy"] - np.asarray(gold["final_xy"])).max(-1)
    rec = {"phase": "campaign", "what": "template_campaign golden",
           "backend": "pallas", "dtype": "float64", "lanes": 64,
           "domains": 8, "wall_s": wall, "launches": launches,
           "success_equal": bool((got["success"].astype(int)
                                  == np.asarray(gold["success"])).all()),
           "min_clearance": float(np.abs(got["min_clearance"] - np.asarray(
               gold["min_clearance"])).max()),
           "qp_ok_frac": float(np.abs(got["qp_ok_frac"] - np.asarray(
               gold["qp_ok_frac"])).max()),
           "final_xy_converged_lanes": float(d_final[ok_lanes].max()),
           "final_xy_all": float(d_final.max()),
           "lanes_with_an_unconverged_qp": int((~ok_lanes).sum()),
           "bound": ("success exact; min_clearance 1e-6; qp_ok_frac 1e-9; "
                     "final_xy 1e-6 on lanes whose every QP converged, 3e-2 "
                     "on the others; K3a and K3b launched, no K1"),
           "device": smi}
    rec["ok"] = (rec["success_equal"] and rec["min_clearance"] <= 1e-6
                 and rec["qp_ok_frac"] <= 1e-9
                 and rec["final_xy_converged_lanes"] <= 1e-6
                 and rec["final_xy_all"] <= 3e-2
                 and launches["K3a"] > 0 and launches["K3b"] > 0
                 and launches["K1a"] == 0 and launches["K1b"] == 0)
    emit(rec)
    check(rec["ok"], f"template_campaign golden on the card: {rec}")
    return launches


def campaign_phase(dev, smi):
    """Phase 12, the template A/B campaign (see the module docstring).
    Returns K1a's launches in the A/B legs and the scaling run, K3's in the
    golden check, and K1a's records on the campaign's own QPs."""
    from srbx_torch import mpc_batch, refplan
    from srbx_torch.eval import campaign, run_campaign_ab
    from srbx_torch.ops import qp_fused
    from srbx_torch.utils import prng

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    out_dir = ROOT / "runs"               # the runner's JSON (git-ignored)
    with open(ROOT / "docs" / "CAMPAIGN_1024.json") as f:
        record = json.load(f)
    n_domains = record["n_domains"]
    pobs, pobs_real = campaign.sample_obstacles(
        prng.split(prng.key(0, dev))[0], record["n_scenarios"], 20, 0.6, f32,
        dev)
    n_scen = pobs.shape[0]
    p32 = torch.tensor(run_campaign_ab.P_START, dtype=f32, device=dev)
    ref_cfg = refplan.two_agent_config(loop_size=CAMPAIGN_LOOP)
    qp_cfg = run_campaign_ab.QP_CFG

    # (a) the batched planner: S 1024, loop 40,000, float32; and 2 fields in
    # float64 against per-field rollouts (loop 4000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes_ref = campaign.plan_lanes(ref_cfg, p32, pobs, 2, f32, dev)
    torch.cuda.synchronize()
    planner_s = time.perf_counter() - t0
    cfg4k = refplan.two_agent_config(loop_size=4_000)
    p64 = p32.double()
    two = pobs[:2].double()
    batch = refplan.generate(cfg4k, p64, two, device=dev)
    rel = 0.0
    for s in range(2):
        one = refplan.generate(cfg4k, p64, two[s], device=dev)
        for a, b in ((batch.pr[s], one.pr), (batch.prd[s], one.prd)):
            rel = max(rel, ((a - b).abs().max() / b.abs().max()).item())
    rec = {"phase": "campaign", "what": "planner", "scenarios": n_scen,
           "loop_size": CAMPAIGN_LOOP, "dtype": "float32",
           "seconds": planner_s,
           "finite": bool(all(torch.isfinite(t).all() for t in lanes_ref)),
           "f64_batched_vs_per_field_rel": rel,
           "bound": "finite; float64 batched vs per-field max|d| / max|ref| "
                    "<= 1e-12 (2 fields, loop 4000)", "device": smi}
    rec["ok"] = rec["finite"] and rel <= 1e-12
    emit(rec)
    check(rec["ok"], f"campaign planner: {rec}")

    # (b) both A/B legs through the runner at full size on the key-0
    # fields. The CBF-SQP leg's cycle inputs of domains 60 and 61 are kept
    # for (d): their lanes interleaved give mixed contacts.
    captured = {}
    real_cycle = mpc_batch.run_nmpc_batch
    sqp_calls = [0]

    def capturing(cfg, qp_cfg_, *args, **kw):
        if cfg.use_sqp:
            if sqp_calls[0] in (60, 61) and sqp_calls[0] not in captured:
                captured[sqp_calls[0]] = (args, kw)
            sqp_calls[0] += 1
        return real_cycle(cfg, qp_cfg_, *args, **kw)

    qp_fused.solve_lanes_last.launches = 0
    with mock.patch.object(mpc_batch, "run_nmpc_batch", capturing):
        summ, results = run_campaign_ab.main(
            n_scen, n_domains, device=dev, loop_size=CAMPAIGN_LOOP,
            out=out_dir / f"CAMPAIGN_TORCH_{n_scen}.json")
    ab_launches = qp_fused.solve_lanes_last.launches
    expect = 2 * n_domains * (1 + 3)      # two runs a leg; 1 and 3 a domain
    legs = {}
    for leg in ("qp_only", "cbf_sqp"):
        legs[leg] = {k: summ[leg][k] for k in (
            "success_rate", "mean_min_clearance", "nonfinite_lanes",
            "qp_ok_frac", "wall_s_first", "wall_s_steady", "planner_s",
            "loop_s", "domains_per_s")}
        legs[leg]["record_success_rate"] = record[leg]["success_rate"]
        legs[leg]["record_qp_ok_frac"] = record[leg]["qp_ok_frac"]
    rec = {"phase": "campaign", "what": "A/B legs", "scenarios": n_scen,
           "agents": 2, "domains": n_domains, "loop_size": CAMPAIGN_LOOP,
           "dtype": "float32", "formulation": summ["formulation"],
           "K1a_launches": ab_launches, "expected_K1a_launches": expect,
           **legs,
           "bound": ("nonfinite_lanes 0; success_rate within 0.01 of "
                     "docs/CAMPAIGN_1024.json; qp_ok_frac >= the record's "
                     "- 0.005; CBF-SQP success above QP-only's; exact K1a "
                     "launches"), "device": smi}
    rec["ok"] = (ab_launches == expect and all(
        v["nonfinite_lanes"] == 0
        and abs(v["success_rate"] - v["record_success_rate"]) <= 0.01
        and v["qp_ok_frac"] >= v["record_qp_ok_frac"] - 0.005
        for v in legs.values())
        and legs["cbf_sqp"]["success_rate"] > legs["qp_only"]["success_rate"])
    emit(rec)
    check(rec["ok"], f"campaign A/B legs: {rec}")

    # where the card's time goes: the first 8 domains (2 stand, 6 trot) of
    # each leg on the planned lanes, under torch.profiler
    few = campaign.CampaignConfig(n_agents=2, n_domains=8)
    for leg in ("qp_only", "cbf_sqp"):
        cfg = run_campaign_ab.leg_config(run_campaign_ab.LEGS[leg])
        run = functools.partial(campaign.run_domains, cfg, qp_cfg, few, p32,
                                *lanes_ref, pobs_real, None, "fused")
        run()
        wall, busy, by_name = device_profile(run)
        k1a = sum(v for k, v in by_name.items() if "qp_fused_noeq" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        emit({"phase": "campaign", "what": "profile", "leg": leg,
              "domains": few.n_domains, "lanes": 2 * n_scen,
              "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / (wall * 1e3),
              "k1a_ms": k1a, "k1a_share_of_busy": k1a / busy if busy else None,
              "top_kernels_ms": top, "device": smi})
    del lanes_ref

    # (c) the CBF-SQP leg in float64 on the same fields: the share of lanes
    # whose success agrees with float32
    t0 = time.perf_counter()
    res64 = campaign._run_campaign_batch_core(
        run_campaign_ab.leg_config(True), qp_cfg,
        campaign.CampaignConfig(n_agents=2, n_domains=n_domains), ref_cfg, p64,
        pobs.double(), pobs_real.double(), None, "fused")
    torch.cuda.synchronize()
    s32 = results["cbf_sqp"].success
    rec = {"phase": "campaign", "what": "f32 vs f64", "leg": "cbf_sqp",
           "wall_s": time.perf_counter() - t0,
           "success_rate_f64": res64.success.double().mean().item(),
           "success_rate_f32": s32.double().mean().item(),
           "success_agreement": (res64.success == s32).double().mean().item(),
           "nonfinite_lanes_f64": int((~torch.isfinite(
               res64.min_clearance)).sum()),
           "bound": "success agrees on >= 0.99 of the lanes", "device": smi}
    rec["ok"] = rec["success_agreement"] >= 0.99
    emit(rec)
    check(rec["ok"], f"campaign float32 vs float64: {rec}")
    del res64, results

    # (d) K1a against its plain version on the campaign's own QPs: domains
    # 60 and 61 of the CBF-SQP leg, lanes interleaved (mixed contacts,
    # every scenario's own field and state), B 2048; the cold mi 28 QP and
    # the first SCP QP (mi 52), in float32 (phase 3's bounds) and float64
    # (phase "mixed"'s); the kernel's ms per launch in float32.
    check(set(captured) == {60, 61}, "domains 60 and 61 were not captured")
    (a60, kw60), (a61, kw61) = captured[60], captured[61]
    n_lanes = a60[1].shape[0]
    even = torch.arange(n_lanes, device=dev) % 2 == 0

    def mix(x, y):
        if isinstance(x, tuple):
            return type(x)(*(mix(u, v) for u, v in zip(x, y)))
        sel = even.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(sel, x, y)

    args = [mix(x, y) for x, y in zip(a60, a61)]
    kw = dict(kw60, state_other=mix(kw60["state_other"],
                                    kw61["state_other"]))
    cfg = run_campaign_ab.leg_config(True)
    n_traj = (cfg.n_state + cfg.n_input) * cfg.horizon
    k1_cases, k1_f64_err = {}, 0.0
    eps_mask = 1.0 if kw["agent_circle_eps"] > 0 else 0.0
    for dtype in (f64, f32):
        lanes = [type(a)(*(t.to(dtype) if t.is_floating_point() else t
                           for t in a)) if isinstance(a, tuple)
                 else a.to(dtype) for a in args]
        qp, cases = cycle_qps(cfg, qp_cfg, lanes,
                              kw["state_other"][:, :2].to(dtype),
                              (("campaign_scp_mi52", (1.0, eps_mask)),),
                              cold="campaign_cold_mi28")
        for case, G, h, x0 in cases:
            xk, _, _, stk = qp_fused.solve_lanes_last(qp.P, qp.c, G, h,
                                                      qp_cfg, x0=x0)
            xp, _, _, stp = qp_fused.solve_lanes_last_plain(
                qp.P, qp.c, G, h, qp_cfg, x0=x0)
            torch.cuda.synchronize()
            conv_k, conv_p = stk[2] > 0.5, stp[2] > 0.5
            both = conv_k & conv_p
            it_k, it_p = stk[3], stp[3]
            traj_k = mpc_batch.expand_ll(qp, xk)[:, :n_traj]
            traj_p = mpc_batch.expand_ll(qp, xp)[:, :n_traj]
            dtraj = (traj_k - traj_p).abs()
            rec = {"phase": "campaign", "what": "K1a vs plain", "case": case,
                   "dtype": str(dtype), "mi": G.shape[0], "lanes": n_lanes,
                   "contacts": sorted({tuple(r) for r in
                                       args[4].tolist()}),
                   "max_abs_dx_converged": (
                       (xk - xp).abs()[:, both].max().item()
                       if both.any() else 0.0),
                   "converged_kernel": conv_k.double().mean().item(),
                   "converged_plain": conv_p.double().mean().item(),
                   "lane_iters_equal": (it_k == it_p).double().mean().item(),
                   "iters_kernel": [it_k.min().item(), it_k.mean().item(),
                                    it_k.max().item()],
                   "max_iters_plain": it_p.max().item()}
            if dtype == f64:
                rec["bound"] = ("lanes converged in both: max|dx| <= 1e-9; "
                                "equal converged flags and per-lane "
                                "iterations")
                rec["ok"] = (rec["max_abs_dx_converged"] <= 1e-9
                             and bool((conv_k == conv_p).all())
                             and rec["lane_iters_equal"] == 1.0)
                k1_f64_err = max(k1_f64_err, rec["max_abs_dx_converged"])
            else:
                rel = (dtraj / traj_p.abs().clamp(min=1.0))[both]
                rec["max_rel_dtraj_converged"] = (rel.max().item()
                                                  if rel.numel() else 0.0)
                rec["bound"] = ("lanes converged in both: trajectory |d| <= "
                                "1e-3 max(1,|traj|); kernel converged share "
                                ">= plain's - 0.5 points; equal max "
                                "iterations")
                rec["ok"] = (rec["max_rel_dtraj_converged"] <= 1e-3
                             and rec["converged_kernel"]
                             >= rec["converged_plain"] - 0.005
                             and it_k.max().item() == it_p.max().item())

                def kern(G=G, h=h, x0=x0, qp=qp):
                    return qp_fused.solve_lanes_last(qp.P, qp.c, G, h,
                                                     qp_cfg, x0=x0)

                def plain(G=G, h=h, x0=x0, qp=qp):
                    return qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h,
                                                           qp_cfg, x0=x0)

                p1 = event_ms(plain, 3)
                t1 = event_ms(kern, REPS)
                t2 = event_ms(kern, REPS)
                p2 = event_ms(plain, 3)
                rec.update(kernel_ms=[t1, t2], plain_ms=[p1, p2])
                k1_cases[case] = dict(
                    mi=G.shape[0], lanes=n_lanes, ms=(t1 + t2) / 2,
                    plain_ms=(p1 + p2) / 2,
                    iters=rec["iters_kernel"],
                    **bound(*k1a_work(qp.P, qp.c, G, h, x0, it_k,
                                      qp_cfg.kkt_refine_iters)))
            rec["device"] = smi
            emit(rec)
            check(rec["ok"], f"K1a on the campaign's QPs: {rec}")
    del captured, args, kw, a60, a61, kw60, kw61

    # (e) the template_campaign golden through K3a and K3b
    k3_launches = campaign_golden_check(dev, smi)

    # (f) one scaling line: the CBF-SQP leg at S 4096 (8192 lanes) on the
    # fields the JAX runner draws from key(0) at that size
    # (docs/CAMPAIGN_4096.json's)
    qp_fused.solve_lanes_last.launches = 0
    summ4, _ = run_campaign_ab.main(
        SCALING_SCENARIOS, n_domains, seed=0, device=dev,
        loop_size=CAMPAIGN_LOOP, legs=("cbf_sqp",),
        out=out_dir / f"CAMPAIGN_TORCH_{SCALING_SCENARIOS}.json")
    scale_launches = qp_fused.solve_lanes_last.launches
    s4 = summ4["cbf_sqp"]
    rec = {"phase": "campaign", "what": "scaling", "leg": "cbf_sqp",
           "scenarios": SCALING_SCENARIOS, "lanes": 2 * SCALING_SCENARIOS,
           "domains": n_domains,
           "K1a_launches": scale_launches,
           **{k: s4[k] for k in ("success_rate", "nonfinite_lanes",
                                 "qp_ok_frac", "wall_s_first",
                                 "wall_s_steady", "planner_s", "loop_s",
                                 "domains_per_s")},
           "bound": "nonfinite_lanes 0; exact K1a launches", "device": smi}
    rec["ok"] = (s4["nonfinite_lanes"] == 0
                 and scale_launches == 2 * 3 * n_domains)
    emit(rec)
    check(rec["ok"], f"campaign scaling line: {rec}")
    emit({"phase": "campaign", "seconds": time.perf_counter() - t_phase})
    return {"K1a": {"campaign_ab": ab_launches,
                    "campaign_scaling": scale_launches},
            "K3": k3_launches, "k1a_cases": k1_cases,
            "k1a_f64_err": k1_f64_err}


def team_golden_plan(dev):
    """The `team` golden's inputs and reference plan (docs/golden/golden.json,
    scripts/make_golden.py:214-238): 1 scenario x 4 agents, the planner on
    the card in float64, as numpy arrays for a side process. It runs here,
    before the side processes start: the planner's graph replays many
    small kernels and slows many times over while other processes share
    the card."""
    from srbx_torch import refplan
    from srbx_torch.eval import run_team

    f64 = torch.float64
    p_start = torch.tensor(run_team.P_START, dtype=f64, device=dev)
    pobs = torch.stack([torch.linspace(3.0, 8.0, 20, dtype=f64),
                        torch.linspace(-2.0, 2.0, 20, dtype=f64)]).to(dev)
    t0 = time.perf_counter()
    ref = refplan.generate(refplan.four_agent_config(loop_size=20_000),
                           p_start, pobs, device=dev)
    torch.cuda.synchronize()
    return {"planner_s": time.perf_counter() - t0,
            **{name: t.cpu().numpy() for name, t in (
                ("p_start", p_start), ("pobs", pobs), ("pr", ref.pr),
                ("prd", ref.prd))}}


def team_golden_run(w):
    """The `team` golden's loop on w.golden's plan (team_golden_plan), as a
    side job: the uncondensed SCP NMPC, QpConfig(), the reduced LL build,
    float64, 300 stand ticks and 2 domains, backend "pallas" (the
    step-fused IPM through K3a and K3b for the NMPC and the LL QP, K2a and
    K2b for the physics and the inverses). Returns its outputs, seconds
    and the kernels' launches in it."""
    from srbx_torch.config import (LowLevelConfig, MotionConfig, MpcConfig,
                                   QpConfig)
    from srbx_torch.models import a1
    from srbx_torch.ops import pallas_linalg as plin, qp_fused, spd
    from srbx_torch.sim import closedloop, wholebody as wb

    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}
    p_start, pobs, pr, prd = (
        torch.as_tensor(w.golden[k], device=w.dev)
        for k in ("p_start", "pobs", "pr", "prd"))
    loop = closedloop.LoopConfig(stand_ticks=300, n_domains=2,
                                 ticks_per_domain=172)
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    sims, com_ends, margins, llok = closedloop.run_team_batch(
        MpcConfig(use_sqp=True, sqp_iters=1), LowLevelConfig(),
        MotionConfig(), QpConfig(), wb.SimConfig(), loop, a1.model(),
        pr.reshape(1, 4, 2, -1), prd.reshape(1, 4, 2, -1),
        p_start.reshape(1, 4, 2), pobs[None], dtype=torch.float64,
        backend="pallas", ll_reduced=True, device=w.dev)
    out = {name: t.cpu().numpy() for name, t in (
        ("com_ends", com_ends), ("margins", margins), ("final_q", sims.q),
        ("llok", llok))}
    return {**out, "wall_s": time.perf_counter() - t0,
            "ticks": loop.stand_ticks + loop.n_domains * loop.ticks_per_domain,
            "launches": {name: k.launches for name, k in counters.items()}}


def team_golden_check(out, planner_s, smi):
    """The team golden's side run (`out`: team_golden_run's) held to the
    golden's own bounds: com_ends, margins and final_q 1e-5, llok 1e-9; K3a
    and K3b launched, K2a and K2b two a tick, no K1. Returns the kernels'
    launches."""
    with open(ROOT / "docs" / "golden" / "golden.json") as f:
        gold = json.load(f)["team"]
    launches, ticks = out["launches"], out["ticks"]
    diff = {name: float(np.abs(out[name] - np.asarray(gold[name])).max())
            for name in ("com_ends", "margins", "final_q", "llok")}
    rec = {"phase": "team", "what": "team golden", "backend": "pallas",
           "dtype": "float64", "scenarios": 1, "agents": 4, "ticks": ticks,
           "planner_s": planner_s, "wall_s": out["wall_s"],
           "run": "a side process, beside phases 15 and 16",
           "max_abs_diff": diff, "launches": launches,
           "bound": ("com_ends, margins and final_q 1e-5, llok 1e-9 (the "
                     "golden's own); K3a and K3b launched, K2a and K2b two a "
                     "tick, no K1"), "device": smi}
    rec["ok"] = (diff["com_ends"] <= 1e-5 and diff["margins"] <= 1e-5
                 and diff["final_q"] <= 1e-5 and diff["llok"] <= 1e-9
                 and launches["K3a"] > 0 and launches["K3b"] > 0
                 and launches["K2a"] == 2 * ticks
                 and launches["K2b"] == 2 * ticks
                 and launches["K1a"] == 0 and launches["K1b"] == 0)
    emit(rec)
    check(rec["ok"], f"team golden on the card: {rec}")
    return launches


def outer_solves(on_call):
    """qp_batch.solve, calling on_call(*args) once for each of a tick's LL
    solves: not again for the equilibrated inner call that the solve makes
    itself (Ruiz)."""
    from srbx_torch.ops import qp_batch

    real_solve, depth = qp_batch.solve, [0]

    def solve(*a, **kw):
        if depth[0] == 0:
            on_call(*a)
        depth[0] += 1
        try:
            return real_solve(*a, **kw)
        finally:
            depth[0] -= 1
    return solve


def team_phase(dev, smi):
    """Phase 13 (a)-(c), the scenario-batched 4-agent team (see the module
    docstring; (d), the team golden, runs in a side process). Returns the
    kernels' launches in the team run and K1b (25, 12)'s case for the
    kernels line."""
    from srbx_torch.config import QpConfig
    from srbx_torch.eval import run_team
    from srbx_torch.models import rbd
    from srbx_torch.ops import pallas_linalg as plin, qp, qp_batch, qp_fused
    from srbx_torch.ops import spd
    from srbx_torch.sim import closedloop, wholebody as wb

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}

    # (a) the team at its production point through the runner: S 1024 x 4
    # agents, the JAX script's key(7) fields, loop 20,000, float32, cut in
    # depth to TEAM_DEPTH (100 stand ticks and the first 50 ticks of 1
    # domain). The
    # LL QPs of stand tick 150 and of the last domain's middle tick are kept
    # for (c), the state at the last domain's start for (b).
    pobs = run_team.sample_fields(TEAM_SCENARIOS, 7, f32, dev)
    run_team.run(pobs, closedloop.LoopConfig(2, 1, 2))         # warm-up
    torch.cuda.reset_peak_memory_stats()
    loop = closedloop.LoopConfig(*TEAM_DEPTH)
    ticks = loop.stand_ticks + loop.n_domains * loop.ticks_per_domain
    keep = {loop.stand_ticks // 2: "stand", loop.stand_ticks
            + (loop.n_domains - 1) * loop.ticks_per_domain
            + loop.ticks_per_domain // 2: "trot"}
    ll_qps, shapes, domain_args = {}, set(), []
    real_domain = closedloop._trot_domain

    def capture(*a):
        tick = len(ll_qps.setdefault("calls", []))
        ll_qps["calls"].append(tick)
        shapes.add((a[1].shape[1], a[2].shape[1]))
        if tick in keep:
            ll_qps[keep[tick]] = ([t.clone() for t in a[:6]], a[6])

    def capturing_domain(*a, **kw):
        domain_args[:] = [a]
        return real_domain(*a, **kw)

    for k in counters.values():
        k.launches = 0
    with mock.patch.object(qp_batch, "solve", outer_solves(capture)), \
            mock.patch.object(closedloop, "_trot_domain", capturing_domain):
        out, planner_s, loop_s = run_team.run(pobs, loop)
    team_launches = {name: k.launches for name, k in counters.items()}
    summ = run_team.summarize(out, loop, planner_s, loop_s)
    expect = {"K1a": 2 * loop.n_domains, "K1b": ticks, "K2a": 2 * ticks,
              "K2b": 2 * ticks, "K3a": 0, "K3b": 0}
    rec = {"phase": "team", "what": "production point", **summ,
           "fields": ("run_team.sample_fields: jax key(7), as "
                      "scripts/run_team_batch_scale.py draws them"),
           "loop_size": 20_000, "dtype": "float32", "backend": "fused",
           "ll_reduced": True, "ll_qp_shapes": sorted(shapes),
           "ll_qp_solves": len(ll_qps["calls"]),
           "launches": team_launches, "expected_launches": expect,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "jax_record": ("64 x 4, 8 domains on the TPU: min inter-agent "
                          "1.08 m, CBF margin 1.90, LL-QP ok 1.000 "
                          "(docs/ROUND1.md:196-199; not gated)"),
           "bound": ("finite; LL-QP ok >= 0.99; every LL QP at (n, me) = "
                     "(25, 12); K1b one launch a tick, K1a two a domain, "
                     "K2a and K2b two a tick, no K3"), "device": smi}
    rec["ok"] = (summ["finite"] and summ["ll_qp_ok"] >= 0.99
                 and shapes == {(25, 12)} and team_launches == expect)
    emit(rec)
    check(rec["ok"], f"team at its production point: {rec}")
    del out

    # (b) where the card's time goes: 5 trot ticks from the state at the
    # last domain's start, under torch.profiler; then the physics of 5
    # ticks alone (2 substeps each, from the same state)
    (args,) = domain_args
    five = args[4]._replace(ticks_per_domain=5)

    def run5():
        real_domain(*args[:4], five, *args[5:])

    run5()
    wall, busy, by_name = device_profile(run5)
    sims, model, sim_cfg = args[6], args[5], args[3]
    d0 = rbd.mass_matrix(model, sims.q)
    tau = torch.zeros(sims.q.shape[0], 12, dtype=f32, device=dev)

    def physics5():
        for _ in range(5):
            wb.step_batch(sim_cfg, model, sims, tau, backend="fused", d0=d0)

    physics5()
    _, phys_busy, _ = device_profile(physics5)
    share = {name: sum(v for k, v in by_name.items() if key in k) / busy
             for name, key in (("K1b", "qp_general"), ("K2", "spd_lane"))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "team", "what": "profile", "ticks": 5,
          "lanes": sims.q.shape[0], "wall_ms_profiled": wall * 1e3,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3),
          "k1b_share_of_busy": share["K1b"], "k2_share_of_busy": share["K2"],
          "physics_busy_ms_alone": phys_busy,
          "physics_share_of_busy": phys_busy / busy,
          "top_kernels_ms": top, "device": smi})
    del args, domain_args, sims, d0

    # (c) K1b (25, 12) against its plain version. Random well-conditioned
    # QPs of the reduced shape in float64 (1e-9, equal flags and per-lane
    # iterations); the loop's own reduced LL QPs after its 5 Ruiz sweeps
    # (the stand tick's lanes interleaved with the trot tick's) in float64
    # and float32; a ragged mixed batch as phase "mixed"; the ms per launch
    # on the loop's float32 QPs. The loop's QPs have a condition near 1e10
    # (aux_pen A'^T A' against df_pen): their force directions are weakly
    # determined, and the plain version alone moves x about as far as the
    # kernel does when h moves by 4 ulps (the record reports both). So in
    # float64 the kernel is held to equal flags and per-lane iterations,
    # tau and the objective to 1e-9, and x to 1e-6 (5.5e-7 measured on the
    # card); in float32 to the converged share within 0.5 points, max
    # |d tau| over the lanes converged in both reported.
    k1b_cases = {}
    rand = random_ll_qps(WB_BATCH, dev, f64, n=25, me=12)
    sk = qp_fused.solve(*rand, QpConfig())
    sp = qp_fused.solve_plain(*rand, QpConfig())
    torch.cuda.synchronize()
    rec = {"phase": "team", "what": "K1b (25, 12) vs plain",
           "case": "random", "dtype": "float64", "lanes": WB_BATCH,
           "max_abs_dx": (sk.x - sp.x).abs().max().item(),
           "converged_equal": bool((sk.converged == sp.converged).all()),
           "lane_iters_equal": bool((sk.lane_iters == sp.lane_iters).all()),
           "converged": sk.converged.double().mean().item(),
           "bound": ("max|dx| <= 1e-9; equal converged flags and per-lane "
                     "iterations")}
    rec["ok"] = (rec["max_abs_dx"] <= 1e-9 and rec["converged_equal"]
                 and rec["lane_iters_equal"])
    k1b_f64_dx = rec["max_abs_dx"]
    emit(rec)
    check(rec["ok"], f"K1b (25, 12) disagrees with its plain version: {rec}")

    (stand, cfg), (trot, _) = ll_qps["stand"], ll_qps["trot"]
    even = (torch.arange(stand[0].shape[0], device=dev) % 2 == 0)
    mixed_qps = [torch.where(even.reshape((-1,) + (1,) * (a.dim() - 1)), a,
                             b).contiguous() for a, b in zip(stand, trot)]
    raw_cfg = dataclasses.replace(cfg, ruiz_iters=0)
    for dtype in (f64, f32):
        data, (d, _, _, _) = qp.ruiz_equilibrate(
            *(mixed_qps[i].to(dtype) for i in (0, 1, 2, 4, 5, 3)),
            cfg.ruiz_iters)
        data = [t.contiguous() for t in data]
        sk = qp_fused.solve(*data, raw_cfg)
        sp = qp_fused.solve_plain(*data, raw_cfg)
        torch.cuda.synchronize()
        both = sk.converged & sp.converged
        dx_unscaled = ((sk.x - sp.x) * d).abs()
        dtau = dx_unscaled[:, 12:24].amax(1)[both]
        rec = {"phase": "team", "what": "K1b (25, 12) vs plain",
               "case": "loop_after_ruiz", "dtype": str(dtype),
               "lanes": data[1].shape[0], "ruiz_iters": cfg.ruiz_iters,
               "max_abs_dx": (sk.x - sp.x).abs().max().item(),
               "max_abs_dtau_converged": (dtau.max().item()
                                          if dtau.numel() else 0.0),
               "converged_kernel": sk.converged.double().mean().item(),
               "converged_plain": sp.converged.double().mean().item(),
               "converged_equal": (sk.converged == sp.converged)
               .double().mean().item(),
               "lane_iters_equal": (sk.lane_iters == sp.lane_iters)
               .double().mean().item(),
               "iters_kernel": [sk.lane_iters.min().item(),
                                sk.lane_iters.mean().item(),
                                sk.lane_iters.max().item()]}
        if dtype == f64:
            h4 = data[5] * (1.0 + 4.0 * torch.finfo(f64).eps)
            sp4 = qp_fused.solve_plain(*data[:5], h4, raw_cfg)

            def objective(x, P=data[0], c=data[1]):
                return (0.5 * torch.einsum("bn,bnm,bm->b", x, P, x)
                        + (c * x).sum(1))

            fk, fp = objective(sk.x), objective(sp.x)
            rec.update(
                max_abs_dforce_unscaled=dx_unscaled[:, 0:12].max().item(),
                max_abs_dtau=dx_unscaled[:, 12:24].max().item(),
                max_rel_dobjective=((fk - fp).abs()
                                    / fp.abs().clamp(min=1.0)).max().item(),
                plain_h_4ulp_max_abs_dx=(sp4.x - sp.x).abs().max().item(),
                plain_h_4ulp_converged_equal=bool(
                    (sp4.converged == sp.converged).all()))
            rec["bound"] = ("equal converged flags and per-lane iterations; "
                            "max|d tau| and the objective's relative "
                            "difference <= 1e-9; max|dx| <= 1e-6 (weakly "
                            "determined force directions: see the plain "
                            "version's own change under a 4-ulp h)")
            rec["ok"] = (rec["converged_equal"] == 1.0
                         and rec["lane_iters_equal"] == 1.0
                         and rec["max_abs_dtau"] <= 1e-9
                         and rec["max_rel_dobjective"] <= 1e-9
                         and rec["max_abs_dx"] <= 1e-6)
        else:
            rec["bound"] = ("kernel converged share within 0.5 points of "
                            "the plain version's")
            rec["ok"] = abs(rec["converged_kernel"]
                            - rec["converged_plain"]) <= 0.005

            def kern(data=data):
                return qp_fused.solve(*data, raw_cfg)

            def plain(data=data):
                return qp_fused.solve_plain(*data, raw_cfg)

            p1 = event_ms(plain, 3)
            t1 = event_ms(kern, REPS)
            t2 = event_ms(kern, REPS)
            p2 = event_ms(plain, 3)
            rec.update(kernel_ms=[t1, t2], plain_ms=[p1, p2])
            k1b_cases["reduced_25_12"] = dict(
                n=25, me=12, mi=data[4].shape[1], lanes=data[1].shape[0],
                ms=(t1 + t2) / 2, plain_ms=(p1 + p2) / 2,
                iters=rec["iters_kernel"],
                **bound(*k1b_work(data, sk, raw_cfg.kkt_refine_iters)))
        rec["device"] = smi
        emit(rec)
        check(rec["ok"], f"K1b (25, 12) on the loop's QPs: {rec}")
    del ll_qps, mixed_qps, data

    mix_lanes = WB_BATCH - 3
    mix_qp = random_ll_qps(mix_lanes, dev, f64, seed=9, n=25, me=12)
    infeasible = make_mixed(mix_qp[4], mix_qp[5])
    mixed_cfg = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                          reg_dual=1e-6, max_iters=12)
    sols = [fn(*mix_qp, mixed_cfg) for fn in (qp_fused.solve,
                                              qp_fused.solve_plain)]
    torch.cuda.synchronize()
    fin = [torch.isfinite(torch.cat([o.x, o.y, o.z, o.s], 1)).all(1)
           for o in sols]
    mixed_record("K1b (25, 12)", mix_lanes, sols[0].x, sols[1].x, *fin,
                 sols[0].converged, sols[1].converged, sols[0].lane_iters,
                 sols[1].lane_iters, infeasible, 7, mixed_cfg.max_iters)

    emit({"phase": "team", "seconds": time.perf_counter() - t_phase})
    return {"team": team_launches, "k1b_cases": k1b_cases,
            "k1b_f64_dx": k1b_f64_dx}


def generic_cycle_qps(cfg, qp_cfg, lanes, other, condensed):
    """The generic cycle's own QPs on `lanes` (run_nmpc_batch's lane
    arguments, carry first), batch-leading, as its branch builds them:
    uncondensed (n 41, me 28) or condensed with the simplex rows kept (n 17,
    me 4). The cold first solve, then the first SCP round's solve with one
    CBF circle and with two (the second `other` (B, 2), the neighbour), warm
    from the first solve's plain solution under qp_cfg. Returns the cold
    QP [P, c, A, b, G, h], the trajectory map (x -> the planned states and
    inputs, (B, 24)) and [(case, G, h, x0)]."""
    from srbx_torch import mpc, mpc_batch, sqp
    from srbx_torch.ocp import (assemble, condense, condense_rows, contract,
                                expand, expansion)
    from srbx_torch.ops import qp_fused

    carry, q, dq, toe, ci, pr, prd, a0, pob = lanes
    dtype, bsz = q.dtype, q.shape[0]
    ci_eff = mpc_batch.effective_contacts(carry, ci)
    x0s, ref, foot = mpc_batch._lane_state(cfg, carry, q, dq, toe, pr, prd,
                                           a0)
    data = assemble(cfg, x0s, ref, foot, ci_eff, dtype=dtype)
    n_traj = (cfg.n_state + cfg.n_input) * cfg.horizon
    if condensed:
        e_mat, e0 = expansion(cfg, x0s, foot, ci_eff, dtype=dtype)
        data = condense(cfg, data, e_mat, e0)

        def traj(x):
            return expand(e_mat, e0, x)[:, :n_traj]
    else:
        def traj(x):
            return x[:, :n_traj]
    data = [t.contiguous() for t in data]
    x = qp_fused.solve_plain(*data, qp_cfg).x
    if condensed:
        x = expand(e_mat, e0, x)
    x_start = (contract(cfg, x, ci_eff) if condensed else x).contiguous()
    circles = torch.stack([mpc.closest_obstacle(q, pob)[0], other], 1)
    vel_g, vel_h = sqp._vel_rows(cfg, dtype, q.device)
    cases = [(f"cold_mi{data[4].shape[1]}", data[4], data[5], None)]
    for mask in ((1.0,), (1.0, 1.0)):
        m = torch.tensor(mask, dtype=dtype, device=q.device).expand(
            bsz, len(mask))
        cbf_g, cbf_h = sqp._cbf_rows(cfg, x, circles[:, :len(mask)], m,
                                     dtype)
        rows = torch.cat([vel_g.expand(bsz, -1, -1), cbf_g], 1)
        rhs = torch.cat([vel_h.expand(bsz, -1), cbf_h], 1)
        if condensed:
            rows, rhs = condense_rows(rows, rhs, e_mat, e0)
        g = torch.cat([data[4], rows], 1).contiguous()
        h = torch.cat([data[5], rhs], 1).contiguous()
        cases.append((f"scp_mi{g.shape[1]}", g, h, x_start))
    return data, traj, cases


def traj_record(phase, kernel, case, dtype, cfg_name, lanes, mi, xk, xp,
                traj_k, traj_p, conv_k, conv_p, it_k, it_p, cert):
    """Kernel against plain version on one batch of the NMPC's own QPs:
    trajectories (the planned states and inputs, which all-stance lanes
    determine although x does not), converged shares and iterations. In
    float64, rounding only: 1e-9 on the trajectory relative to max(1,
    |traj|), equal flags and maximum iterations. In float32 each stops at
    its own point inside the relaxed tolerance, whose primal scale holds
    the box rows' 1e3 where they are kept, so the trajectories are
    reported and the kernel's answers are certified instead: its converged
    share at most 0.5 points below the plain version's, and every lane it
    calls converged meeting the stopping test recomputed in float64
    (`cert`, from `certify`, within 1 %)."""
    dtraj = (traj_k - traj_p).abs() / traj_p.abs().clamp(min=1.0)
    both = conv_k & conv_p
    rec = {"phase": phase, "kernel": kernel, "case": case,
           "dtype": str(dtype), "config": cfg_name, "lanes": lanes, "mi": mi,
           "max_abs_dx": (xk - xp).abs().max().item(),
           "max_rel_dtraj": dtraj.max().item(),
           "max_rel_dtraj_converged": (dtraj[both].max().item()
                                       if both.any() else 0.0),
           "converged_kernel": conv_k.double().mean().item(),
           "converged_plain": conv_p.double().mean().item(),
           "converged_equal": bool((conv_k == conv_p).all()),
           "max_iters_kernel": float(it_k.max()),
           "max_iters_plain": float(it_p.max())}
    if dtype == torch.float64:
        rec["bound"] = ("trajectory |d| <= 1e-9 max(1, |traj|); equal "
                        "converged flags and max iterations")
        rec["ok"] = (rec["max_rel_dtraj"] <= 1e-9 and rec["converged_equal"]
                     and rec["max_iters_kernel"] == rec["max_iters_plain"])
    else:
        rec["certified_share_of_converged"], \
            rec["max_recomputed_res_converged"] = cert
        rec["bound"] = ("kernel converged share >= plain's - 0.5 points; "
                        "every kernel-converged lane meets the stopping test "
                        "recomputed in float64 (x1.01)")
        rec["ok"] = (rec["certified_share_of_converged"] == 1.0
                     and rec["converged_kernel"]
                     >= rec["converged_plain"] - 0.005)
    emit(rec)
    check(rec["ok"], f"{kernel} disagrees with its plain version: {rec}")
    return rec


def nmpc_fused_phase(dev, smi, inputs, p_start, relaxed, strict,
                     pallas_times):
    """Phase 14, the NMPC on backend "fused" off the benchmark's
    configuration (see the module docstring). `pallas_times` holds phase
    11's generic cycles/s by solver configuration. Returns the kernels-line
    rows of K1b (41, 28), K1b (17, 4) and K1a above 64 rows, and the cases
    and launches to add to the K1a and K1b rows."""
    from srbx_torch import mpc_batch
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ops import qp_batch, qp_fused

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    cfg41 = MpcConfig(use_sqp=True, sqp_iters=2)
    cfg17 = MpcConfig(use_sqp=True, sqp_iters=2, condensed=True,
                      elide_box_rows=True)
    cfg13 = MpcConfig(use_sqp=True, sqp_iters=2, condensed=True,
                      elide_simplex=True)
    n_traj = (cfg41.n_state + cfg41.n_input) * cfg41.horizon
    mixed_cfg = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                         reg_dual=1e-6, max_iters=12)
    errs = {"K1b_41_28": 0.0, "K1b_17_4": 0.0, "K1a_mi_gt_64": 0.0}
    counts = (qp_fused.solve, qp_fused.solve_lanes_last)
    counts0 = [k.launches for k in counts]
    calls = [0, 0]

    def other(dtype, count):
        return torch.tensor(p_start[2:], dtype=dtype, device=dev).expand(
            count, 2)

    def lanes_last(*ts):
        return [t.permute(*range(1, t.dim()), 0).contiguous() for t in ts]

    def k1a_leading(qp, G, h, x, z, s_, stat):
        """A K1a QP and solution batch-leading, with no equality rows."""
        P, c, G, h = (t.movedim(-1, 0) for t in (qp.P, qp.c, G, h))
        bsz, n = c.shape
        sol = types.SimpleNamespace(x=x.T, y=c.new_zeros(bsz, 0), z=z.T,
                                    s=s_.T, converged=stat[2] > 0.5)
        return (P, c, c.new_zeros(bsz, 0, n), c.new_zeros(bsz, 0), G,
                h), sol

    # (a) random well-conditioned QPs of each new shape and mi, float64:
    # rounding only, 1e-9 in x, equal flags and per-lane iterations
    for key, (n, me), mis in (("K1b_41_28", (41, 28), (92, 112, 116)),
                              ("K1b_17_4", (17, 4),
                               (28, 48, 52, 92, 112, 116)),
                              ("K1a_mi_gt_64", (13, 0), (92, 112, 116))):
        for mi in mis:
            lanes = WB_BATCH - 3 if me else NMPC_CHECK_LANES - 5
            data = random_ll_qps(lanes, dev, f64, seed=mi, n=n, me=me, mi=mi)
            if me:
                sk = qp_fused.solve(*data, QpConfig())
                sp = qp_fused.solve_plain(*data, QpConfig())
                xk, xp, ck, cp, ik, ip = (sk.x, sp.x, sk.converged,
                                          sp.converged, sk.lane_iters,
                                          sp.lane_iters)
                calls[0] += 1
            else:
                ops = lanes_last(*(data[i] for i in (0, 1, 4, 5)))
                ok_ = qp_fused.solve_lanes_last(*ops, QpConfig())
                op_ = qp_fused.solve_lanes_last_plain(*ops, QpConfig())
                xk, xp, ck, cp, ik, ip = (ok_[0], op_[0], ok_[3][2] > 0.5,
                                          op_[3][2] > 0.5, ok_[3][3],
                                          op_[3][3])
                calls[1] += 1
            torch.cuda.synchronize()
            rec = {"phase": "nmpc_fused_kernel", "kernel": key,
                   "case": "random", "dtype": "torch.float64", "lanes": lanes,
                   "n": n, "me": me, "mi": mi,
                   "max_abs_dx": (xk - xp).abs().max().item(),
                   "converged": ck.double().mean().item(),
                   "converged_equal": bool((ck == cp).all()),
                   "lane_iters_equal": bool((ik == ip).all()),
                   "resident_warps_f32": qp_fused.resident_warps(
                       f32, mi, bool(me), (n, me)),
                   "resident_warps_f64": qp_fused.resident_warps(
                       f64, mi, bool(me), (n, me)),
                   "bound": ("max|dx| <= 1e-9; equal converged flags and "
                             "per-lane iterations")}
            rec["ok"] = (rec["max_abs_dx"] <= 1e-9 and rec["converged_equal"]
                         and rec["lane_iters_equal"])
            errs[key] = max(errs[key], rec["max_abs_dx"])
            emit(rec)
            check(rec["ok"], f"{key} disagrees with its plain version: {rec}")

    # (b) ragged batches mixing converging, infeasible and one NaN lane in
    # every block, as phase "mixed", at the largest mi
    for key, (n, me), lanes in (("K1b (41, 28)", (41, 28), WB_BATCH - 3),
                                ("K1b (17, 4)", (17, 4), WB_BATCH - 3),
                                ("K1a mi 116", (13, 0), BATCH - 5)):
        data = random_ll_qps(lanes, dev, f64, seed=9, n=n, me=me, mi=116)
        infeasible = make_mixed(data[4], data[5])
        if me:
            sols = [fn(*data, mixed_cfg) for fn in (qp_fused.solve,
                                                    qp_fused.solve_plain)]
            calls[0] += 1
            fin = [torch.isfinite(torch.cat([o.x, o.y, o.z, o.s], 1)).all(1)
                   for o in sols]
            args = (sols[0].x, sols[1].x, *fin, sols[0].converged,
                    sols[1].converged, sols[0].lane_iters,
                    sols[1].lane_iters)
        else:
            ops = lanes_last(*(data[i] for i in (0, 1, 4, 5)))
            outs = [fn(*ops, mixed_cfg) for fn in (
                qp_fused.solve_lanes_last, qp_fused.solve_lanes_last_plain)]
            calls[1] += 1
            fin = [torch.isfinite(x).all(0) & torch.isfinite(z).all(0)
                   & torch.isfinite(s_).all(0) for x, z, s_, _ in outs]
            args = (outs[0][0].T, outs[1][0].T, *fin, outs[0][3][2] > 0.5,
                    outs[1][3][2] > 0.5, outs[0][3][3], outs[1][3][3])
        torch.cuda.synchronize()
        mixed_record(key, lanes, *args, infeasible, 7, mixed_cfg.max_iters)
        del data

    # (c) the NMPC's own QPs: cold, the first SCP round's with one CBF
    # circle and with the neighbour's too; K1b at (41, 28) and (17, 4) on
    # NMPC_CHECK_LANES lanes, K1a with the box rows kept on all B
    def k1a_box_qps(dtype):
        return cycle_qps(cfg13, strict, lanes_of(inputs, dev, dtype),
                         other(dtype, BATCH),
                         (("scp_mi112", (1.0,)), ("scp_mi116", (1.0, 1.0))),
                         cold="cold_mi92")

    for dtype, qp_cfg, cfg_name in ((f64, strict, "strict"),
                                    (f32, relaxed, "relaxed")):
        for key, cfg, condensed in (("K1b_41_28", cfg41, False),
                                    ("K1b_17_4", cfg17, True)):
            lanes = lanes_of(inputs, dev, dtype, NMPC_CHECK_LANES)
            data, traj, cases = generic_cycle_qps(
                cfg, strict, lanes, other(dtype, NMPC_CHECK_LANES), condensed)
            for case, G, h, x0 in cases:
                d = data[:4] + [G, h]
                sk = qp_fused.solve(*d, qp_cfg, x0=x0)
                sp = qp_fused.solve_plain(*d, qp_cfg, x0=x0)
                torch.cuda.synchronize()
                calls[0] += 1
                rec = traj_record("nmpc_fused_kernel", key, case, dtype,
                                  cfg_name, NMPC_CHECK_LANES, G.shape[1],
                                  sk.x, sp.x, traj(sk.x), traj(sp.x),
                                  sk.converged, sp.converged, sk.lane_iters,
                                  sp.lane_iters,
                                  certify(d, sk, qp_cfg, 1.01))
                if dtype == f64:
                    errs[key] = max(errs[key], rec["max_rel_dtraj"])
            del data, cases, lanes
        qp, cases = k1a_box_qps(dtype)
        direct = {}
        for case, G, h, x0 in cases:
            xk, zk, sk_, stk = qp_fused.solve_lanes_last(qp.P, qp.c, G, h,
                                                         qp_cfg, x0=x0)
            direct[case] = xk
            xp, _, _, stp = qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h,
                                                            qp_cfg, x0=x0)
            torch.cuda.synchronize()
            calls[1] += 1
            rec = traj_record(
                "nmpc_fused_kernel", "K1a_mi_gt_64", case, dtype, cfg_name,
                BATCH, G.shape[0], xk, xp,
                mpc_batch.expand_ll(qp, xk)[:, :n_traj],
                mpc_batch.expand_ll(qp, xp)[:, :n_traj], stk[2] > 0.5,
                stp[2] > 0.5, stk[3], stp[3],
                certify(*k1a_leading(qp, G, h, xk, zk, sk_, stk), qp_cfg,
                        1.01))
            if dtype == f64:
                errs["K1a_mi_gt_64"] = max(errs["K1a_mi_gt_64"],
                                           rec["max_rel_dtraj"])
        if dtype == f64:
            # an inequality-only QP through qp_fused.solve (me = 0) runs
            # K1a, as the JAX package's solve runs its noeq kernel there:
            # the same launch as solve_lanes_last on the same lanes, so
            # bitwise its x; against the plain version, the trajectory
            case, G, h, x0 = cases[1]
            lead = [t.movedim(-1, 0).contiguous() for t in (qp.P, qp.c, G, h,
                                                            x0)]
            no_a = lead[1].new_zeros(BATCH, 0, 13)
            no_b = lead[1].new_zeros(BATCH, 0)
            n0 = qp_fused.solve_lanes_last.launches
            sk = qp_fused.solve(lead[0], lead[1], no_a, no_b, lead[2],
                                lead[3], qp_cfg, x0=lead[4])
            sp = qp_fused.solve_plain(lead[0], lead[1], no_a, no_b, lead[2],
                                      lead[3], qp_cfg, x0=lead[4])
            torch.cuda.synchronize()
            calls[1] += 1
            traj_k = mpc_batch.expand_ll(qp, sk.x.T)[:, :n_traj]
            traj_p = mpc_batch.expand_ll(qp, sp.x.T)[:, :n_traj]
            rec = {"phase": "nmpc_fused_kernel", "kernel": "K1a via "
                   "qp_fused.solve (me = 0)", "case": case,
                   "dtype": "torch.float64", "lanes": BATCH,
                   "bitwise_solve_lanes_last": bool(torch.equal(
                       sk.x.T, direct[case])),
                   "max_abs_dx": (sk.x - sp.x).abs().max().item(),
                   "max_rel_dtraj": ((traj_k - traj_p).abs()
                                     / traj_p.abs().clamp(min=1.0)).max()
                   .item(),
                   "converged_equal": bool((sk.converged
                                            == sp.converged).all()),
                   "y_shape": list(sk.y.shape),
                   "k1a_launches": qp_fused.solve_lanes_last.launches - n0,
                   "bound": ("one K1a launch, bitwise solve_lanes_last's x; "
                             "against the plain version trajectory |d| <= "
                             "1e-9 max(1, |traj|) and equal converged "
                             "flags; y (B, 0)")}
            rec["ok"] = (rec["k1a_launches"] == 1
                         and rec["bitwise_solve_lanes_last"]
                         and rec["max_rel_dtraj"] <= 1e-9
                         and rec["converged_equal"]
                         and rec["y_shape"] == [BATCH, 0])
            emit(rec)
            check(rec["ok"], f"qp_fused.solve at me = 0: {rec}")
        del qp, cases, direct
    check([k.launches - c for k, c in zip(counts, counts0)] == calls,
          "the fused kernels' counters did not advance once per call")

    # (d) each new case's ms per launch against its plain version's, on the
    # cycle's own QPs, float32, relaxed, B = 131072 (and K1b (41, 28)'s
    # cold QP at B = 4096 too), with its bound from the run's iterations
    by_case = {"K1b_41_28": {}, "K1b_17_4": {}, "K1a_mi_gt_64": {}}
    timing = [("K1b_41_28", cfg41, False, BATCH),
              ("K1b_41_28", cfg41, False, WB_BATCH),
              ("K1b_17_4", cfg17, True, BATCH)]
    for key, cfg, condensed, count in timing:
        lanes = lanes_of(inputs, dev, f32, count)
        data, _, cases = generic_cycle_qps(cfg, strict, lanes,
                                           other(f32, count), condensed)
        for case, G, h, x0 in (cases if count == BATCH else cases[:1]):
            d = data[:4] + [G, h]

            def kern():
                return qp_fused.solve(*d, relaxed, x0=x0)

            def plain():
                return qp_fused.solve_plain(*d, relaxed, x0=x0)

            sol = kern()
            plain()
            p1 = event_ms(plain, 1)
            t1 = event_ms(kern, K1_NEW_REPS)
            t2 = event_ms(kern, K1_NEW_REPS)
            p2 = event_ms(plain, 1)
            row = dict(n=d[1].shape[1], me=d[2].shape[1], mi=G.shape[1],
                       lanes=count, ms=(t1 + t2) / 2, plain_ms=(p1 + p2) / 2,
                       mean_lane_iters=sol.lane_iters.double().mean().item(),
                       **bound(*k1b_work(d, sol, relaxed.kkt_refine_iters)))
            by_case[key][f"nmpc_{case}_b{count}"] = row
            emit({"phase": "nmpc_fused_times", "kernel": key, "case": case,
                  "dtype": "float32", "config": "relaxed",
                  "kernel_ms": [t1, t2], "plain_ms": [p1, p2], **row,
                  "device": smi})
        del data, cases, lanes
    qp, cases = k1a_box_qps(f32)
    for case, G, h, x0 in cases:
        def kern_a():
            return qp_fused.solve_lanes_last(qp.P, qp.c, G, h, relaxed,
                                             x0=x0)

        def plain_a():
            return qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h, relaxed,
                                                   x0=x0)

        stat = kern_a()[3]
        plain_a()
        p1 = event_ms(plain_a, 1)
        t1 = event_ms(kern_a, REPS)
        t2 = event_ms(kern_a, REPS)
        p2 = event_ms(plain_a, 1)
        row = dict(mi=G.shape[0], lanes=BATCH, ms=(t1 + t2) / 2,
                   plain_ms=(p1 + p2) / 2,
                   mean_lane_iters=stat[3].double().mean().item(),
                   **bound(*k1a_work(qp.P, qp.c, G, h, x0, stat[3],
                                     relaxed.kkt_refine_iters)))
        by_case["K1a_mi_gt_64"][f"nmpc_box_rows_{case}"] = row
        emit({"phase": "nmpc_fused_times", "kernel": "K1a_mi_gt_64",
              "case": case, "dtype": "float32", "config": "relaxed",
              "kernel_ms": [t1, t2], "plain_ms": [p1, p2], **row,
              "device": smi})
    del qp, cases

    # (e) the reference-shape cycle on "fused": run_nmpc_batch(backend=
    # "fused", condensed=False) at B = 131072, float32, relaxed and strict,
    # on the generic cycle's inputs; the QPs' shapes are recorded at
    # qp_batch.solve (the wrappers' counters give the launches)
    shapes = []
    real_solve = qp_batch.solve

    def recording_solve(*a, **kw):
        shapes.append((a[1].shape[1], a[2].shape[1], a[4].shape[1]))
        return real_solve(*a, **kw)

    def counted(cfg, condensed, qp_cfg, args):
        shapes.clear()
        for k in counts:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(qp_batch, "solve", recording_solve):
            out = mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args,
                                           backend="fused",
                                           condensed=condensed)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            "K1b": qp_fused.solve.launches,
            "K1a": qp_fused.solve_lanes_last.launches}

    def rates(cfg, condensed, qp_cfg, args, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args, backend="fused",
                                     condensed=condensed)
        torch.cuda.synchronize()
        pipelined = BATCH * reps / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(reps):
            mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args, backend="fused",
                                     condensed=condensed)
            torch.cuda.synchronize()
        return pipelined, BATCH * reps / (time.perf_counter() - t0)

    def finite(out):
        return all(bool(torch.isfinite(getattr(out, n)).all()) for n in (
            "alpha_com", "states", "inputs", "x", "cbf_margin"))

    args = lanes_of(inputs, dev, f32)
    mpc_batch.run_nmpc_batch(cfg41, relaxed, *args, backend="fused",
                             condensed=False)            # warm-up
    torch.cuda.synchronize()
    launches = {}
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        out, wall, got = counted(cfg41, False, qp_cfg, args)
        if cfg_name == "relaxed":
            launches["generic_cycle_fused"] = got["K1b"]
        expect = {"K1b": 1 + cfg41.sqp_iters, "K1a": 0}
        pipelined, synced = rates(cfg41, False, qp_cfg, args, GEN_REPS)
        rec = {"phase": "nmpc_fused_cycle", "what": "uncondensed, K1b "
               "(41, 28)", "config": cfg_name, "lanes": BATCH,
               "dtype": "float32", "qp_shapes": list(shapes),
               "launches": got, "expected_launches": expect,
               "converged": out.qp_converged.double().mean().item(),
               "qp_iters": int(out.qp_iters), "wall_s": wall,
               "finite": finite(out), "reps": GEN_REPS,
               "cycles_per_s_pipelined": pipelined,
               "cycles_per_s_synced": synced,
               "pallas_cycles_per_s": pallas_times[cfg_name],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "bound": ("finite; exactly 1 + sqp_iters K1b launches, all "
                         "at (41, 28), no K1a; first solve's converged "
                         "share >= 0.9 relaxed"), "device": smi}
        rec["ok"] = (rec["finite"] and got == expect
                     and all(s[:2] == (41, 28) for s in shapes)
                     and (cfg_name == "strict" or rec["converged"] >= 0.9))
        emit(rec)
        check(rec["ok"], f"fused generic cycle check failed: {rec}")

    # the first lanes in float64 through K1b and through its plain version
    args64 = lanes_of(inputs, dev, f64, CROSS_LANES)
    with mock.patch.object(qp_fused, "solve", qp_fused.solve_plain):
        ref64 = mpc_batch.run_nmpc_batch(cfg41, strict, *args64,
                                         backend="fused", condensed=False)
    ker64 = mpc_batch.run_nmpc_batch(cfg41, strict, *args64, backend="fused",
                                     condensed=False)
    torch.cuda.synchronize()
    cross = {"phase": "nmpc_fused_cycle", "what": "f64 K1b vs plain",
             "lanes": CROSS_LANES, "config": "strict",
             "states": float((ker64.states - ref64.states).abs().max()),
             "alpha_com": float((ker64.alpha_com
                                 - ref64.alpha_com).abs().max()),
             "converged_equal": bool((ker64.qp_converged
                                      == ref64.qp_converged).all()),
             "converged": ker64.qp_converged.double().mean().item(),
             "bound": "states and alpha_com <= 1e-9; equal converged flags"}
    cross["ok"] = (cross["states"] <= 1e-9 and cross["alpha_com"] <= 1e-9
                   and cross["converged_equal"])
    emit(cross)
    check(cross["ok"], f"fused generic cycle cross-check failed: {cross}")
    del args64, ref64, ker64

    # (f) one cycle each of the condensed configuration with the simplex
    # rows kept (K1b (17, 4)) and of the condensed, simplex-eliminated one
    # with the box rows kept (K1a at mi 92 / 112)
    for what, path, cfg, key, shape in (
            ("condensed, K1b (17, 4)", "cycle_condensed_17_4", cfg17, "K1b",
             (17, 4)),
            ("condensed, simplex-eliminated, box rows kept, K1a",
             "cycle_box_rows_kept", cfg13, "K1a", None)):
        mpc_batch.run_nmpc_batch(cfg, relaxed, *args, backend="fused",
                                 condensed=True)         # warm-up
        out, wall, got = counted(cfg, True, relaxed, args)
        launches[path] = got[key]
        expect = {"K1b": 0, "K1a": 0}
        expect[key] = 1 + cfg.sqp_iters
        pipelined, _ = rates(cfg, True, relaxed, args, GEN_REPS)
        rec = {"phase": "nmpc_fused_cycle", "what": what,
               "config": "relaxed", "lanes": BATCH, "dtype": "float32",
               "qp_shapes": list(shapes), "launches": got,
               "expected_launches": expect,
               "converged": out.qp_converged.double().mean().item(),
               "qp_iters": int(out.qp_iters), "wall_s": wall,
               "finite": finite(out), "reps": GEN_REPS,
               "cycles_per_s_pipelined": pipelined,
               "bound": "finite; exact launch counts", "device": smi}
        rec["ok"] = (rec["finite"] and got == expect and all(
            s[:2] == shape for s in shapes))
        emit(rec)
        check(rec["ok"], f"fused cycle check failed: {rec}")
    emit({"phase": "nmpc_fused", "seconds": time.perf_counter() - t_phase})

    rows = []
    for key, name, source, main_case, path in (
            ("K1b_41_28", "qp_general_41_28", "srbx_torch/csrc/qp_general.cu",
             f"nmpc_cold_mi92_b{BATCH}", "generic_cycle_fused"),
            ("K1b_17_4", "qp_general_17_4", "srbx_torch/csrc/qp_general.cu",
             f"nmpc_cold_mi28_b{BATCH}", "cycle_condensed_17_4"),
            ("K1a_mi_gt_64", "qp_fused_noeq_mi_gt_64",
             "srbx_torch/csrc/qp_fused.cu", "nmpc_box_rows_scp_mi112",
             "cycle_box_rows_kept")):
        case = by_case[key][main_case]
        rows.append(dict(
            name=name, route="cuda", source=source,
            replaces="srbx/ops/qp_fused.py:94", launches=launches[path],
            max_abs_err=errs[key], library_ms=None,
            **{f: case[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "bytes", "flops")},
            launches_by_path={path: launches[path]}, by_case=by_case[key]))
    return rows


def plain_kernels():
    """A context in which the K1a, K1b, K2a, K2b, K3a and K3b wrappers run
    their plain PyTorch versions (no launch, no count)."""
    from srbx_torch.ops import pallas_linalg as plin, qp_fused, spd

    def plain_lanes_last(P, c, G, h, qp_cfg, x0=None):
        return qp_fused.solve_lanes_last_plain(P, c, G, h, qp_cfg, x0=x0)

    stack = contextlib.ExitStack()
    for mod, name, fn in ((qp_fused, "solve", qp_fused.solve_plain),
                          (qp_fused, "solve_lanes_last", plain_lanes_last),
                          (spd, "solve", spd.solve_plain),
                          (spd, "inverse", spd.inverse_plain),
                          (plin, "batch_cholesky", plin.batch_cholesky_plain),
                          (plin, "batch_cho_solve",
                           plin.batch_cho_solve_plain)):
        stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


def host_ms(fn, reps=10):
    """Wall ms per call of fn (host and device, a synchronize at the end)
    over `reps` back-to-back calls, after one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_est(w, dtype, n, loop, ll_qp_cfg=None):
    """closedloop.run_batch with estimation in the loop at the est_loop
    phase's configuration (`w`: the whole-body phase's model, configurations
    and references) on its first n lanes."""
    from srbx_torch.estimation import pipeline
    from srbx_torch.sim import closedloop
    from srbx_torch.utils import prng

    return closedloop.run_batch(
        w.mpc, w.ll_cfg, w.motion_cfg, w.relaxed, w.sim_cfg, loop, w.model,
        *w.lanes(dtype, n), dtype=dtype, backend="fused", ll_reduced=True,
        ll_qp_cfg=ll_qp_cfg, est_cfg=pipeline.EstConfig(),
        est_key=prng.key(11, w.dev), device=w.dev)


def run_event(w, dtype, n, stand, ticks, ll_qp_cfg=None):
    """closedloop.run_batch_event with estimation at the event phase's
    configuration on the first n lanes of `w`."""
    from srbx_torch.estimation import pipeline
    from srbx_torch.sim import closedloop
    from srbx_torch.utils import prng

    loop = closedloop.LoopConfig(stand_ticks=stand, mpc_latency_ticks=20)
    return closedloop.run_batch_event(
        w.mpc, w.ll_cfg, w.motion_cfg, w.relaxed, w.sim_cfg, loop, w.model,
        *w.lanes(dtype, n), ticks, dtype=dtype, backend="fused",
        ll_reduced=True, ll_qp_cfg=ll_qp_cfg, mpc_period_ticks=20,
        est_cfg=pipeline.EstConfig(), est_key=prng.key(11, w.dev),
        device=w.dev)


def loop_lanes(dev, pr, prd, a0, pobs):
    """The lanes of the loops: lanes(dtype, n) -> their first n lanes'
    (pr, prd, a0, pobs) on the card in dtype."""
    def lanes(dtype, n):
        return tuple(torch.as_tensor(t[:n]).to(device=dev, dtype=dtype)
                     for t in (pr, prd, a0, pobs))
    return lanes


def _cross_ll_cfg(w):
    # float64 holds the float32 runs' LL configuration (5 Ruiz sweeps): raw,
    # the reduced LL QP's condition near 1e10 leaves its force directions
    # to rounding (ROADMAP F10)
    return dataclasses.replace(w.relaxed, ruiz_iters=5)


def crosses(w, plain):
    """The est_loop and event phases' float64 runs of their first
    WB_CROSS_LANES lanes, through the kernels or (plain) through their
    plain versions, as numpy."""
    from srbx_torch.sim import closedloop

    f64 = torch.float64
    with plain_kernels() if plain else contextlib.nullcontext():
        est = run_est(w, f64, WB_CROSS_LANES,
                      closedloop.LoopConfig(*EST_CROSS), _cross_ll_cfg(w))
        ev = run_event(w, f64, WB_CROSS_LANES, *EVENT_CROSS,
                       _cross_ll_cfg(w))
    out = {"est." + k: v for k, v in cross_record(est).items()}
    out.update({"event." + k: v for k, v in cross_record(ev).items()})
    return out


def cross_record(res):
    """What a float64 cross-check compares of a loop's result, as numpy."""
    names = ("q", "com_hist", "est_rmse", "qp_ok", "trigger_hist",
             "domains", "mpc_solves")
    vals = (res.sim.q, res.com_hist, getattr(res, "est_rmse", None),
            res.qp_ok,
            getattr(res, "trigger_hist", None), getattr(res, "domains", None),
            getattr(res, "mpc_solves", None))
    return {k: v.cpu().numpy() for k, v in zip(names, vals)
            if v is not None}


def dist_push(dev, n, start, dur, dtype):
    """The disturbance phase's pulses on n lanes: (0, 10, ..., 90)[lane %
    10] N at scripts/campaign_push.py's key(7) azimuths (the first n of its
    stream), from trot tick `start` for `dur` ticks."""
    from srbx_torch.utils import prng

    k_az = prng.split(prng.key(7, dev))[0]
    mags = 10.0 * (torch.arange(n, device=dev) % 10).to(torch.float32)
    az = prng.uniform(k_az, (n,), torch.float32, 0.0, 2 * np.pi)
    force = torch.stack([mags * torch.cos(az), mags * torch.sin(az),
                         torch.zeros_like(mags)], 1).to(dtype)
    return (force,
            torch.full((n,), start, dtype=torch.int32, device=dev),
            torch.full((n,), dur, dtype=torch.int32, device=dev))


def run_dist(w, dtype, n, loop, push=None, stiction=True, use_clf=True,
             ll_qp_cfg=None):
    """closedloop.run_batch at the disturbance phase's configuration
    (scripts/campaign_push.py's QP-only condensed NMPC, the reduced LL
    build, backend "fused") on the first n lanes of `w`, with stick-slip
    contact, the CLF row and the pulses `push` as asked."""
    from srbx_torch.config import LowLevelConfig, MpcConfig
    from srbx_torch.sim import closedloop

    mpc = MpcConfig(use_sqp=False, condensed=True, elide_box_rows=True,
                    elide_simplex=True)
    return closedloop.run_batch(
        mpc, LowLevelConfig(use_clf=use_clf), w.motion_cfg, w.relaxed,
        w.sim_cfg, loop, w.model, *w.lanes(dtype, n), dtype=dtype,
        backend="fused", tile=128, ll_reduced=True, ll_qp_cfg=ll_qp_cfg,
        stiction=stiction, push=push, device=w.dev)


def dist_record(res):
    """What the disturbance phase compares of a run, as numpy."""
    out = cross_record(res)
    out["slip"] = res.sim.con.slip.cpu().numpy()
    return out


def dist_crosses(w):
    """The disturbance phase's float64 side runs on its first
    WB_CROSS_LANES lanes: through the kernels and the plain versions over
    DIST_CROSS (pulses from trot tick 2), and through the kernels at the
    phase's depth; all with the float32 run's LL configuration (5 Ruiz
    sweeps), so that against the float32 run only the dtype differs."""
    from srbx_torch.sim import closedloop

    f64, n = torch.float64, WB_CROSS_LANES
    cross = closedloop.LoopConfig(*DIST_CROSS)
    push = dist_push(w.dev, n, *DIST_CROSS_PUSH, f64)
    out = {"ker." + k: v for k, v in dist_record(run_dist(
        w, f64, n, cross, push, ll_qp_cfg=_cross_ll_cfg(w))).items()}
    with plain_kernels():
        out.update({"plain." + k: v for k, v in dist_record(run_dist(
            w, f64, n, cross, push, ll_qp_cfg=_cross_ll_cfg(w))).items()})
    deep = run_dist(w, f64, n, closedloop.LoopConfig(*DIST_DEPTH),
                    dist_push(w.dev, n, *DIST_PUSH, f64),
                    ll_qp_cfg=_cross_ll_cfg(w))
    out.update({"deep." + k: v for k, v in dist_record(deep).items()})
    return out


def clf_pair32(w):
    """The CLF-on/CLF-off pair in float32 at the disturbance phase's
    configuration without push or stiction, on the first WB_CROSS_LANES
    lanes over CLF_PAIR."""
    from srbx_torch.sim import closedloop

    out = {}
    for use_clf in (True, False):
        res = run_dist(w, torch.float32, WB_CROSS_LANES,
                       closedloop.LoopConfig(*CLF_PAIR), stiction=False,
                       use_clf=use_clf)
        out.update({f"f32.{'on' if use_clf else 'off'}.{k}": v
                    for k, v in cross_record(res).items()})
    return out


def clf_pair(w):
    """The CLF-on/CLF-off pair without push or stiction on the first
    WB_CROSS_LANES lanes over CLF_PAIR, in float64 at
    scripts/campaign_clf.py's configuration: the uncondensed NMPC without
    SCP, the full LL build, QpConfig() for both (K1b at (41, 28) and
    (43, 30))."""
    from srbx_torch.config import LowLevelConfig, MpcConfig, QpConfig
    from srbx_torch.sim import closedloop

    n, loop = WB_CROSS_LANES, closedloop.LoopConfig(*CLF_PAIR)
    out = {}
    for use_clf in (True, False):
        res = closedloop.run_batch(
            MpcConfig(use_sqp=False), LowLevelConfig(use_clf=use_clf),
            w.motion_cfg, QpConfig(), w.sim_cfg, loop, w.model,
            *w.lanes(torch.float64, n), dtype=torch.float64,
            backend="fused", device=w.dev)
        out.update({f"f64.{'on' if use_clf else 'off'}.{k}": v
                    for k, v in cross_record(res).items()})
    return out


def run_gait(w, gait, dtype, n, stand, ticks, backend="fused",
             reduced=True, ll_qp_cfg=None):
    """closedloop.run_velocity_gait at the velocity-gait phase's
    configuration (tests/test_wholebody.py:214-216: MotionConfig(fwd_speed=
    0.15), its relaxed QpConfig; the whole-body phase's model and lanes
    `w`) for `gait` (a Gait name) on the first n lanes."""
    from srbx_torch.config import Gait
    from srbx_torch.sim import closedloop

    return closedloop.run_velocity_gait(
        Gait[gait], w.ll_cfg, dataclasses.replace(w.motion_cfg,
                                                   fwd_speed=0.15),
        vel_qp_cfg(), w.sim_cfg, closedloop.LoopConfig(stand_ticks=stand),
        w.model, w.lanes(dtype, n)[2], ticks, dtype=dtype, backend=backend,
        ll_reduced=reduced, ll_qp_cfg=ll_qp_cfg, device=w.dev)


def vel_qp_cfg():
    """The JAX package's velocity-gait tests' LL solver configuration."""
    from srbx_torch.config import QpConfig

    return QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                    reg_dual=1e-6, max_iters=12)


def velocity_crosses(w, plain):
    """Every gait of VEL_FORMS in float64 on the first WB_CROSS_LANES lanes
    over VEL_CROSS, through the kernels or (plain) their plain versions;
    the reduced build with 5 Ruiz sweeps (the float32 run's), the full one
    raw."""
    out = {}
    with plain_kernels() if plain else contextlib.nullcontext():
        for gait, (backend, reduced) in VEL_FORMS.items():
            res = run_gait(w, gait, torch.float64, WB_CROSS_LANES,
                           *VEL_CROSS, backend, reduced,
                           dataclasses.replace(vel_qp_cfg(), ruiz_iters=5)
                           if reduced else None)
            out.update({f"{gait}.{k}": v
                        for k, v in cross_record(res).items()})
    return out


def wb_crosses(w):
    """The whole-body phase's float64 runs of its first WB_CROSS_LANES
    lanes over WB_CROSS, through the kernels and through the plain
    versions."""
    from srbx_torch.sim import closedloop

    out = {}
    for tag, plain in (("ker", False), ("plain", True)):
        with plain_kernels() if plain else contextlib.nullcontext():
            res = closedloop.run_batch(
                w.mpc, w.ll_cfg, w.motion_cfg, w.relaxed, w.sim_cfg,
                closedloop.LoopConfig(*WB_CROSS), w.model,
                *w.lanes(torch.float64, WB_CROSS_LANES),
                dtype=torch.float64, device=w.dev)
        out.update({f"{tag}.{k}": v for k, v in cross_record(res).items()})
    return out


def wholebody_cross(res, smi):
    """Phase 7's float64 kernels-vs-plain line from its side job's
    result: q and COM within 1e-9."""
    rec = {"phase": "wholebody", "what": "float64 kernels vs plain",
           "lanes": WB_CROSS_LANES, "ticks": list(WB_CROSS),
           "max_abs_dq": float(np.abs(res["ker.q"] - res["plain.q"]).max()),
           "max_abs_dcom": float(np.abs(res["ker.com_hist"]
                                        - res["plain.com_hist"]).max()),
           "seconds": res["seconds"], "bound": "q and COM within 1e-9",
           "device": smi}
    rec["ok"] = max(rec["max_abs_dq"], rec["max_abs_dcom"]) <= 1e-9
    emit(rec)
    check(rec["ok"], f"whole-body loop, kernels vs plain: {rec}")


def _agent_reference(p_start, loop_size, dev, dtype=torch.float64):
    """The two-agent APF reference from p_start among far obstacles, and
    the obstacles (2, 20)."""
    from srbx_torch import refplan

    pobs = torch.full((2, 20), 100.0, dtype=dtype, device=dev)
    traj = refplan.generate(refplan.two_agent_config(loop_size=loop_size),
                            torch.tensor(p_start, dtype=dtype, device=dev),
                            pobs, dtype=dtype, device=dev)
    return traj, pobs


def agent_run_cross(w):
    """Phase 19's part 1 (float64): closedloop.run, one agent, at
    tests/test_wholebody.py:165-199's configuration (MpcConfig(use_sqp=
    False), the default LL, motion, solver and plant configurations; lane 0
    of that test: from the origin on the reference of agent 0) over
    AGENT_RUN, and run_batch(backend="xla") at B 1 on the same inputs."""
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.sim import closedloop

    traj, pobs = _agent_reference([0.0, 0.0, 0.0, -1.0], 20_000, w.dev)
    args = (MpcConfig(use_sqp=False), w.ll_cfg, w.motion_cfg, QpConfig(),
            w.sim_cfg, closedloop.LoopConfig(*AGENT_RUN), w.model)
    a0 = torch.zeros(2, dtype=torch.float64, device=w.dev)
    t0 = time.perf_counter()
    res = closedloop.run(*args, traj.pr[0:2], traj.prd[0:2], a0, pobs,
                         device=w.dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bat = closedloop.run_batch(*args, traj.pr[None, 0:2],
                               traj.prd[None, 0:2], a0[None], pobs[None],
                               backend="xla", device=w.dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"run_s": t1 - t0, "batch_s": t2 - t1,
            "run.q": res.sim.q.cpu().numpy(),
            "run.com_hist": res.com_hist.cpu().numpy(),
            "run.qp_ok": float(res.qp_ok), "run.mpc_ok": float(res.mpc_ok),
            "batch.q": bat.sim.q[0].cpu().numpy(),
            "batch.com_hist": bat.com_hist[0].cpu().numpy(),
            "batch.qp_ok": float(bat.qp_ok[0]),
            "batch.mpc_ok": float(bat.mpc_ok[0])}


def agent_team_cross(w):
    """Phase 19's part 2 (float64): closedloop.run_team, two agents, at
    tests/test_team.py:50-100's configuration (MpcConfig(use_sqp=False),
    starts 1 m apart, the reference of loop 8000) over AGENT_TEAM, and
    run_team_batch(backend="xla") at S 1 on the same inputs."""
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.sim import closedloop

    p_start = [0.0, 0.5, 0.0, -0.5]
    traj, pobs = _agent_reference(p_start, 8_000, w.dev)
    args = (MpcConfig(use_sqp=False), w.ll_cfg, w.motion_cfg, QpConfig(),
            w.sim_cfg, closedloop.LoopConfig(*AGENT_TEAM), w.model)
    pr, prd = traj.pr.reshape(2, 2, -1), traj.prd.reshape(2, 2, -1)
    a0 = torch.tensor(p_start, dtype=torch.float64,
                      device=w.dev).reshape(2, 2)
    t0 = time.perf_counter()
    _, com1, mar1, ok1 = closedloop.run_team(*args, pr, prd, a0, pobs,
                                             device=w.dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, com2, mar2, ok2 = closedloop.run_team_batch(
        *args, pr[None], prd[None], a0[None], pobs[None], backend="xla",
        device=w.dev)
    torch.cuda.synchronize()
    return {"run_s": t1 - t0, "batch_s": time.perf_counter() - t1,
            "run.com_ends": com1.cpu().numpy(),
            "run.margins": mar1.cpu().numpy(), "run.llok": ok1.cpu().numpy(),
            "batch.com_ends": com2[:, 0].cpu().numpy(),
            "batch.margins": mar2[:, 0].cpu().numpy(),
            "batch.llok": ok2[:, 0].cpu().numpy()}


SIDE_JOBS = {"golden": team_golden_run, "wb": wb_crosses,
             "est": functools.partial(crosses, plain=False),
             "est_plain": functools.partial(crosses, plain=True),
             "dist": dist_crosses, "clf32": clf_pair32, "clf": clf_pair,
             "vel": functools.partial(velocity_crosses, plain=False),
             "vel_plain": functools.partial(velocity_crosses, plain=True),
             "agent_run": agent_run_cross, "agent_team": agent_team_cross}
# the side processes beside phases 15 and 16, each running its jobs in
# turn: five of about the team golden's length rather than one a job, so
# that they do not outnumber the host's cores or crowd the card with
# contexts (a context's kernels wait while another's run)
SIDE_GROUPS = (("golden",), ("est_plain", "wb"), ("clf", "est"),
               ("clf32", "dist"), ("vel_plain", "vel"))
# phase 19's float64 runs: a sixth side process, started with the five and
# waited for before phase 17. Its two jobs take about 150 s alone on the
# card, more than any of the five groups leaves free beside phases 15-16
AGENT_GROUP = ("agent_run", "agent_team")


def _side_main(queue, payload):
    """A side process: the jobs payload["jobs"] of SIDE_JOBS in turn, their
    results sent back through `queue` with the seconds each took and the
    wall-clock times at which the process was ready and done, or the error
    that stopped them."""
    try:
        ready = time.time()
        sys.path.insert(0, str(ROOT))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        w = types.SimpleNamespace(**payload["cfgs"])
        w.dev = torch.device(payload["dev"])
        w.lanes = loop_lanes(w.dev, *payload["lanes"])
        w.golden = payload["golden"]
        from srbx_torch.ops import qp_batch

        jobs = {}
        for job in payload["jobs"]:
            t0 = time.perf_counter()
            with qp_batch.full_f32_products():
                out = SIDE_JOBS[job](w)
            jobs[job] = {"ok": True, "seconds": time.perf_counter() - t0,
                         **out}
        queue.put({"ok": True, "jobs": jobs, "ready": ready,
                   "done": time.time()})
    except Exception:                          # noqa: BLE001 - reported
        import traceback

        queue.put({"ok": False, "error": traceback.format_exc()})


def start_side(w, jobs):
    """Start a side process of the float64 runs `jobs` (names in SIDE_JOBS;
    slow: the loops are host-bound, the plain IPM and SPD solves eager
    PyTorch), so that they overlap phases 15 and 16 and each other; returns
    (process, queue, jobs, start time). The kernels are built already;
    w.golden is the team golden's plan (team_golden_plan)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    n = WB_CROSS_LANES
    payload = {"cfgs": {k: getattr(w, k) for k in (
                   "model", "ll_cfg", "motion_cfg", "sim_cfg", "mpc",
                   "relaxed")}, "dev": str(w.dev), "jobs": jobs,
               "golden": w.golden if "golden" in jobs else None,
               "lanes": tuple(torch.as_tensor(t[:n]).cpu().numpy()
                              for t in (w.pr, w.prd, w.a0, w.pobs))}
    proc = ctx.Process(target=_side_main, args=(queue, payload),
                       daemon=True)
    started = time.time()
    proc.start()
    return proc, queue, jobs, started


def finish_side(side, timeout=600):
    """The side process's results (read before the join); the process is
    joined, or stopped. A process that dies without a result fails within
    seconds, not at the timeout."""
    import queue as queue_mod

    proc, queue = side[:2]
    deadline = time.perf_counter() + timeout
    out = None
    while out is None and time.perf_counter() < deadline:
        try:
            out = queue.get(timeout=5)
        except queue_mod.Empty:
            if not proc.is_alive():
                try:
                    out = queue.get(timeout=5)
                except queue_mod.Empty:
                    break
    if out is None:
        out = {"ok": False, "error": "no result from the side process "
               f"(exit code {proc.exitcode})"}
    proc.join(timeout=60)
    if proc.is_alive():
        proc.terminate()
        proc.join()
    return out


def finish_sides(sides, smi):
    """Every side process's results, job name -> result; fails on the first
    process that failed. Emits how long each process took to be ready and
    to run its jobs, and how long this process waited for them."""
    t0 = time.perf_counter()
    outs = [finish_side(side) for side in sides]
    waited = time.perf_counter() - t0
    for out in outs:
        check(out["ok"], f"a side process failed: {out}")
    emit({"phase": "side_processes", "device": smi, "waited_s": waited,
          "processes": [{"jobs": list(side[2]),
                         "start_to_ready_s": out["ready"] - side[3],
                         "run_s": out["done"] - out["ready"],
                         "job_s": {job: out["jobs"][job]["seconds"]
                                   for job in side[2]}}
                        for side, out in zip(sides, outs)]})
    return {job: res for out in outs for job, res in out["jobs"].items()}


def side_results(sides, smi):
    """A getter of the side processes' results by job name: its first call
    waits for every process (finish_sides), later calls read them."""
    results = {}

    def get(job):
        if not results:
            results.update(finish_sides(sides, smi))
        return results[job]
    return get


def estimation_phases(dev, smi, w, side):
    """Phases 15 (est_loop) and 16 (event): estimation in the loop through
    run_batch, and the event-driven loop with estimation through
    run_batch_event, at B = WB_BATCH float32 on the whole-body phase's lanes
    (`w`), beside the side processes; their first lanes in float64 through
    the kernels, held to the same runs through the plain versions, both
    made by the side processes (`side`: side_results' getter, read after
    the two float32 runs). Returns each phase's kernel launches."""
    from srbx_torch.estimation import kalman, kinest, pipeline
    from srbx_torch.ops import pallas_linalg as plin, qp_fused, spd
    from srbx_torch.sim import closedloop, sensors
    from srbx_torch.utils import prng
    from srbx_torch.utils import transforms as tf

    f32 = torch.float32
    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}
    est_cfg = pipeline.EstConfig()

    # ------------------------- 15. est_loop --------------------------- #
    t_phase = time.perf_counter()
    loop = closedloop.LoopConfig(*EST_DEPTH)
    ticks = loop.stand_ticks + loop.n_domains * loop.ticks_per_domain
    run_est(w, f32, WB_BATCH, closedloop.LoopConfig(2, 1, 2))  # warm-up
    torch.cuda.synchronize()
    real_domain = closedloop._trot_domain
    domain_args = []

    def capturing_domain(*a, **kw):
        domain_args[:] = [a]
        return real_domain(*a, **kw)

    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(closedloop, "_trot_domain", capturing_domain):
        res = run_est(w, f32, WB_BATCH, loop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    expect = {"K1a": 2 * loop.n_domains, "K1b": ticks, "K2a": 2 * ticks,
              "K2b": 2 * ticks, "K3a": 0, "K3b": 0}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.est_rmse))
    final_z = res.com_hist[:, -1, -1, 2]
    rmse = res.est_rmse.double()
    rec = {"phase": "est_loop", "lanes": WB_BATCH, "dtype": "float32",
           "config": ("scripts/campaign_wholebody.py batch-r est: condensed "
                      "lanes-last CBF-SQP NMPC (sqp_iters 1, relaxed), "
                      "reduced LL build (5 Ruiz sweeps), backend fused, "
                      "EstConfig() (kinEst), est_key key(11)"),
           "cut": (f"{loop.stand_ticks} stand ticks and the first "
                   f"{loop.ticks_per_domain} ticks of 1 domain "
                   "against the script's 800 "
                   "and 40; one field (the whole-body phase's lanes, "
                   "obstacles 100 m away), not S fields"),
           "ticks_per_lane": ticks, "wall_s": wall,
           "ll_ticks_per_s": WB_BATCH * ticks / wall,
           "ms_per_tick": wall * 1e3 / ticks,
           "ll_qp_ok": res.qp_ok.double().mean().item(),
           "ll_qp_ok_min": res.qp_ok.min().item(),
           "mpc_ok": res.mpc_ok.double().mean().item(),
           "est_rmse_pos_mm_p50": rmse[:, 0].median().item() * 1e3,
           "est_rmse_pos_mm_max": rmse[:, 0].max().item() * 1e3,
           "est_rmse_vel_p50": rmse[:, 1].median().item(),
           "est_rmse_vel_max": rmse[:, 1].max().item(),
           "final_com_z_min": final_z.min().item(),
           "launches": launches, "expected_launches": expect,
           "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "jax_record": ("docs/CAMPAIGN_WB_EST.json: 256 x 40 domains, "
                          "worst lane 11.9 mm / 0.046 m/s (not gated)"),
           "bound": ("finite; final COM z > 0.2 m on every lane; LL qp_ok "
                     ">= 0.99; est RMSE <= 20 mm and <= 0.1 m/s on every "
                     "lane; exact launch counts"), "device": smi}
    rec["ok"] = (finite and final_z.min().item() > 0.2
                 and rec["ll_qp_ok"] >= 0.99
                 and rec["est_rmse_pos_mm_max"] <= 20.0
                 and rec["est_rmse_vel_max"] <= 0.1 and launches == expect)
    emit(rec)
    check(rec["ok"], f"estimation in the loop: {rec}")
    del res

    # where a tick's time goes: 5 trot ticks from the last domain's start
    # under torch.profiler; then the estimator's parts, host-inclusive, on
    # the same state
    (args,) = domain_args
    five = args[4]._replace(ticks_per_domain=5)

    def run5():
        real_domain(*args[:4], five, *args[5:])

    run5()
    pwall, busy, by_name = device_profile(run5)
    sims, asts, ests = args[6], args[7], args[11]
    phases = asts.loco_tick / float(w.motion_cfg.trot_dom_ticks)
    _, rd = sensors.read(est_cfg.sensor, w.sim_cfg, w.model, ests.sens, sims)
    rot = tf.rot_xyz(rd.eul)
    # base-pinned kinematics as the pipeline evaluates them (the body rates
    # stand in for the Euler rates: the timing does not read the values)
    q_fk = torch.cat([torch.zeros_like(rd.eul), rd.eul, rd.q_joints], 1)
    qd_fk = torch.cat([torch.zeros_like(rd.eul), rd.gyro, rd.qd_joints], 1)
    ci = ests.contact_ind.to(f32)

    def prng_tick():
        ks = prng.split(ests.sens.key, 7)
        return prng.normals(ks[:, 1:], sensors._READ_SHAPES, f32)

    def kf_tick():
        toes = kinest.toes_and_velocities(w.model, q_fk, qd_fk)[0]
        return kalman.update(
            ests.kf, ci, rd.imu_accel, rot, -toes, dt=w.sim_cfg.dt,
            accel_noise=est_cfg.kf_accel_noise,
            meas_noise=est_cfg.kf_meas_noise, g=w.model.g,
            swing_noise=est_cfg.kf_swing_noise)

    def kin_tick():
        return kinest.update(w.model, ests.kin, rd.q_joints, qd_fk, rd.eul,
                             rd.foot_force, ci,
                             force_thresh=est_cfg.contact_force_thresh)

    est_ms = {
        "prng": host_ms(prng_tick),
        "sensors_read_with_prng": host_ms(lambda: sensors.read(
            est_cfg.sensor, w.sim_cfg, w.model, ests.sens, sims)),
        "kf_with_fk": host_ms(kf_tick),
        "kinest_with_fk": host_ms(kin_tick),
        "pipeline_update": host_ms(lambda: pipeline.update(
            est_cfg, w.sim_cfg, w.model, ests, sims, phases))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "est_loop", "what": "profile", "ticks": 5,
          "lanes": WB_BATCH, "wall_ms_profiled": pwall * 1e3,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / (pwall * 1e3),
          "estimator_host_ms_per_tick": est_ms,
          "estimator_share_of_tick": est_ms["pipeline_update"]
          / (wall * 1e3 / ticks),
          "top_kernels_ms": top, "device": smi})
    del args, domain_args, sims, asts, ests, rd
    est_seconds = time.perf_counter() - t_phase

    # --------------------------- 16. event ---------------------------- #
    t_phase = time.perf_counter()
    stand, n_ticks = EVENT_DEPTH
    ticks = stand + n_ticks
    run_event(w, f32, WB_BATCH, 2, 2)                          # warm-up
    torch.cuda.synchronize()
    real_nmpc = closedloop._nmpc
    polls = [0]

    def counting_nmpc(*a, **kw):
        polls[0] += 1
        return real_nmpc(*a, **kw)

    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(closedloop, "_nmpc", counting_nmpc):
        res = run_event(w, f32, WB_BATCH, stand, n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev_launches = {name: k.launches for name, k in counters.items()}
    expect = {"K1a": 2 * polls[0], "K1b": ticks, "K2a": 2 * ticks,
              "K2b": 2 * ticks, "K3a": 0, "K3b": 0}
    trig = res.trigger_hist.cpu().numpy()
    first, contact_gaps, time_gaps, lane_ok = [], 0, 0, []
    for row in trig:
        t = np.nonzero(row)[0]
        gaps = np.diff(t)
        first.append(int(t[0]) if t.size else -1)
        contact_gaps += int((gaps < 181).sum())
        time_gaps += int((gaps >= 181).sum())
        lane_ok.append(bool(((gaps > 120) & (gaps < 181)).any()))
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.est_rmse))
    final_z = res.com_hist[:, -1, 2]
    rmse = res.est_rmse.double()
    doms = res.domains.double()
    solves = res.mpc_solves.double()
    rec = {"phase": "event", "lanes": WB_BATCH, "dtype": "float32",
           "config": ("scripts/campaign_event.py ... est: mpc_period_ticks "
                      "20, mpc_latency_ticks 20, condensed lanes-last "
                      "CBF-SQP NMPC (sqp_iters 1, relaxed), reduced LL "
                      "build, backend fused, EstConfig(), est_key key(11)"),
           "cut": (f"{EVENT_DEPTH[0]} stand ticks and {EVENT_DEPTH[1]} "
                   "trot ticks against 800 and 1720"),
           "ticks_per_lane": ticks, "wall_s": wall,
           "ll_ticks_per_s": WB_BATCH * ticks / wall,
           "hl_polls": polls[0],
           "domains_p50": doms.median().item(),
           "domains_min": doms.min().item(),
           "mpc_solves_per_lane": [solves.min().item(), solves.mean().item(),
                                   solves.max().item()],
           "contact_triggered_domains": contact_gaps,
           "time_triggered_domains": time_gaps,
           "kickoff_at_tick_0": all(f == 0 for f in first),
           "lanes_with_contact_domain_120_181": float(np.mean(lane_ok)),
           "ll_qp_ok": res.qp_ok.double().mean().item(),
           "ll_qp_ok_min": res.qp_ok.min().item(),
           "est_rmse_pos_mm_p50": rmse[:, 0].median().item() * 1e3,
           "est_rmse_pos_mm_max": rmse[:, 0].max().item() * 1e3,
           "est_rmse_vel_p50": rmse[:, 1].median().item(),
           "est_rmse_vel_max": rmse[:, 1].max().item(),
           "final_com_z_min": final_z.min().item(), "finite": finite,
           "launches": ev_launches, "expected_launches": expect,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bound": ("every lane kicked off at tick 0 and ends a contact-"
                     "triggered domain of 121-180 ticks; finite; final COM "
                     "z > 0.2 m on every lane; LL qp_ok >= 0.95; exact "
                     "launch counts (K1a two a poll)"), "device": smi}
    rec["ok"] = (rec["kickoff_at_tick_0"] and all(lane_ok) and finite
                 and final_z.min().item() > 0.2 and rec["ll_qp_ok"] >= 0.95
                 and ev_launches == expect)
    emit(rec)
    check(rec["ok"], f"event-driven loop: {rec}")
    del res, trig
    event_seconds = time.perf_counter() - t_phase

    # the first lanes in float64 through the kernels, held to the plain
    # versions' runs (the same inputs and key): q, COM and est RMSE within
    # 1e-9, equal qp_ok; for the event loop also trigger ticks, domains and
    # solves equal
    ker, plain = side("est"), side("est_plain")
    for out in (ker, plain):
        check(out["ok"], f"the float64 runs failed: {out}")
    for phase, path, what in (("est_loop", "est", list(EST_CROSS)),
                              ("event", "event", list(EVENT_CROSS))):
        k, p = ({key.split(".", 1)[1]: v for key, v in out.items()
                 if key.startswith(path + ".")} for out in (ker, plain))
        rec = {"phase": phase, "what": "float64 kernels vs plain",
               "lanes": WB_CROSS_LANES, "ticks": what,
               "ll_qp_cfg": "relaxed, 5 Ruiz sweeps (the float32 run's)",
               "runs": "side processes, beside phases 15 and 16",
               "max_abs_dq": float(np.abs(k["q"] - p["q"]).max()),
               "max_abs_dcom": float(np.abs(k["com_hist"]
                                            - p["com_hist"]).max()),
               "max_abs_drmse": float(np.abs(k["est_rmse"]
                                             - p["est_rmse"]).max()),
               "qp_ok_equal": bool(np.array_equal(k["qp_ok"], p["qp_ok"])),
               "device": smi}
        exact = ["qp_ok_equal"]
        if path == "event":
            trig = k["trigger_hist"]
            rec.update(
                trigger_ticks_equal=bool(np.array_equal(
                    trig, p["trigger_hist"])),
                triggers=int(trig.sum()),
                lanes_with_a_trigger_after_tick_0=float(
                    trig[:, 1:].any(1).mean()),
                domains_equal=bool(np.array_equal(k["domains"],
                                                  p["domains"])),
                mpc_solves_equal=bool(np.array_equal(k["mpc_solves"],
                                                     p["mpc_solves"])))
            exact += ["trigger_ticks_equal", "domains_equal",
                      "mpc_solves_equal"]
        rec["bound"] = (f"{', '.join(exact)}; q, COM and est RMSE within "
                        "1e-9")
        rec["ok"] = (all(rec[e] for e in exact)
                     and max(rec["max_abs_dq"], rec["max_abs_dcom"],
                             rec["max_abs_drmse"]) <= 1e-9)
        emit(rec)
        check(rec["ok"], f"{phase}, kernels vs plain: {rec}")
    emit({"phase": "est_loop", "seconds": est_seconds})
    emit({"phase": "event", "seconds": event_seconds,
          "float64_runs_s": {"kernels": ker["seconds"],
                             "plain": plain["seconds"]}})
    return {"est_loop": launches, "event": ev_launches}


def disturbance_phase(dev, smi, w, dist, clf):
    """Phase 17 (disturbance): run_batch with stick-slip contact, the CLF
    row and a push on every lane at B = WB_BATCH float32 on the whole-body
    phase's lanes (`w`), and the side processes' results (`dist`:
    dist_crosses'; `clf`: clf_pair32's and clf_pair's). Returns the
    kernels' launches."""
    from srbx_torch.ops import pallas_linalg as plin, qp_fused, spd
    from srbx_torch.sim import closedloop

    t_phase = time.perf_counter()
    f32 = torch.float32
    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}
    for out in (dist, clf):
        check(out["ok"], f"the disturbance phase's side runs failed: {out}")
    loop = closedloop.LoopConfig(*DIST_DEPTH)
    ticks = loop.stand_ticks + loop.n_domains * loop.ticks_per_domain
    run_dist(w, f32, WB_BATCH, closedloop.LoopConfig(2, 1, 2),
             dist_push(dev, WB_BATCH, 0, 2, f32))              # warm-up
    torch.cuda.synchronize()
    real_domain = closedloop._trot_domain
    domain_args = []

    def capturing_domain(*a, **kw):
        domain_args[:] = [a]
        return real_domain(*a, **kw)

    push = dist_push(dev, WB_BATCH, *DIST_PUSH, f32)
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(closedloop, "_trot_domain", capturing_domain):
        res = run_dist(w, f32, WB_BATCH, loop, push)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    expect = {"K1a": loop.n_domains, "K1b": ticks, "K2a": 2 * ticks,
              "K2b": 2 * ticks, "K3a": 0, "K3b": 0}

    # the push campaign's success rule, per lane
    q = res.sim.q.double()
    finite = (torch.isfinite(q).all(1) & torch.isfinite(res.sim.qd).all(1)
              & torch.isfinite(res.com_hist.reshape(WB_BATCH, -1)).all(1)
              & torch.isfinite(res.sim.con.slip).all(1))
    standing = ((q[:, 2] > 0.18) & (q[:, 2] < 0.40) & (q[:, 3].abs() < 0.5)
                & (q[:, 4].abs() < 0.5))
    llok_final = res.tau_hist[:, -1, 1].double() > 0.995
    success = standing & finite & llok_final
    mags = 10 * (torch.arange(WB_BATCH, device=dev) % 10)
    low = mags <= 30
    slip = res.sim.con.slip.double().amax(1)       # a lane's largest toe slip
    qp_ok = res.qp_ok.double()
    curve = {str(m): success[mags == m].double().mean().item()
             for m in range(0, 100, 10)}
    rec = {"phase": "disturbance", "lanes": WB_BATCH, "dtype": "float32",
           "config": ("scripts/campaign_push.py: QP-only condensed NMPC "
                      "(relaxed), reduced LL build (5 Ruiz sweeps), backend "
                      "fused; stiction=True, LowLevelConfig(use_clf=True); "
                      "every lane pushed at (0, 10, ..., 90)[lane % 10] N, "
                      "key(7) azimuths, from trot tick 10 for 300 ticks"),
           "cut": (f"{loop.stand_ticks} stand ticks and the first "
                   f"{loop.ticks_per_domain} ticks of 1 domain "
                   "against the script's 800 and 10 domains; pulses from "
                   "trot tick 10 (the script's onsets lie in trot ticks "
                   f"344-1203) over the run's last "
                   f"{loop.ticks_per_domain - DIST_PUSH[0]} ticks; the "
                   "whole-body phase's lanes"),
           "ticks_per_lane": ticks, "wall_s": wall,
           "ll_ticks_per_s": WB_BATCH * ticks / wall,
           "ms_per_tick": wall * 1e3 / ticks,
           "le30N_lanes": int(low.sum()),
           "le30N_finite": bool(finite[low].all()),
           "le30N_standing_share": standing[low].double().mean().item(),
           "le30N_ll_qp_ok": qp_ok[low].mean().item(),
           "le30N_ll_qp_ok_min": qp_ok[low].min().item(),
           "le30N_slip_m_p50": slip[low].median().item(),
           "le30N_slip_m_max": slip[low].max().item(),
           "slip_m_p50": slip.median().item(),
           "slip_m_max": slip.max().item(),
           "ll_qp_ok": qp_ok.mean().item(),
           "mpc_ok": res.mpc_ok.double().mean().item(),
           "finite_lanes": int(finite.sum()),
           "success_vs_push_N": curve,
           "success_total": success.double().mean().item(),
           "launches": launches, "expected_launches": expect,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bound": ("lanes at or under 30 N: finite, every one standing "
                     "(the push rule's z and attitude), LL qp_ok >= 0.9; "
                     "exact launch counts"), "device": smi}
    rec["ok"] = (rec["le30N_finite"] and rec["le30N_standing_share"] == 1.0
                 and rec["le30N_ll_qp_ok"] >= 0.9 and launches == expect)
    emit(rec)
    check(rec["ok"], f"disturbance: {rec}")
    slip32 = slip[:WB_CROSS_LANES].cpu().numpy()
    del res

    # where a tick's time goes: 5 trot ticks from the domain's start
    (args,) = domain_args
    five = args[4]._replace(ticks_per_domain=5)

    def run5():
        real_domain(*args[:4], five, *args[5:])

    run5()
    pwall, busy, by_name = device_profile(run5)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "disturbance", "what": "profile", "ticks": 5,
          "lanes": WB_BATCH, "wall_ms_profiled": pwall * 1e3,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / (pwall * 1e3),
          "top_kernels_ms": top, "device": smi})
    del args, domain_args

    # the first lanes in float64 through the kernels and the plain versions
    k, p = ({key.split(".", 1)[1]: v for key, v in dist.items()
             if key.startswith(pre)} for pre in ("ker.", "plain."))
    rec = {"phase": "disturbance", "what": "float64 kernels vs plain",
           "lanes": WB_CROSS_LANES, "ticks": list(DIST_CROSS),
           "push_from_trot_tick": DIST_CROSS_PUSH[0],
           "ll_qp_cfg": "relaxed, 5 Ruiz sweeps (the float32 run's)",
           "max_abs_dq": float(np.abs(k["q"] - p["q"]).max()),
           "max_abs_dcom": float(np.abs(k["com_hist"]
                                        - p["com_hist"]).max()),
           "max_abs_dslip": float(np.abs(k["slip"] - p["slip"]).max()),
           "slip_max": float(k["slip"].max()),
           "qp_ok_equal": bool(np.array_equal(k["qp_ok"], p["qp_ok"])),
           "bound": "qp_ok equal; q, COM and slip within 1e-9",
           "device": smi}
    rec["ok"] = (rec["qp_ok_equal"] and max(
        rec["max_abs_dq"], rec["max_abs_dcom"], rec["max_abs_dslip"]) <= 1e-9)
    emit(rec)
    check(rec["ok"], f"disturbance, kernels vs plain: {rec}")
    slip64 = dist["deep.slip"].max(1)
    emit({"phase": "disturbance", "what": "slip float64 vs float32",
          "lanes": WB_CROSS_LANES, "ticks": list(DIST_DEPTH),
          "slip_m_p50_f64": float(np.median(slip64)),
          "slip_m_p50_f32": float(np.median(slip32)),
          "slip_m_max_f64": float(slip64.max()),
          "slip_m_max_f32": float(slip32.max()),
          "ll_qp_cfg": "relaxed, 5 Ruiz sweeps in both dtypes",
          "max_abs_dslip": float(np.abs(slip64 - slip32).max()),
          "ll_qp_ok_f64": float(dist["deep.qp_ok"].mean()),
          "finite_f64": bool(np.isfinite(dist["deep.q"]).all()),
          "device": smi})

    # the CLF-on/CLF-off pair without push or stiction
    with open(ROOT / "docs" / "CLF_LOOP.json") as f:
        record = json.load(f)
    rec = {"phase": "disturbance", "what": "CLF on/off",
           "lanes": WB_CROSS_LANES, "ticks": list(CLF_PAIR),
           "config_f64": ("scripts/campaign_clf.py: MpcConfig(use_sqp="
                          "False) uncondensed, the full LL build, "
                          "QpConfig(), backend fused"),
           "config_f32": "the disturbance phase's, no push, no stiction",
           "record": {"com_dist_vs_noclf_max": record[
               "com_dist_vs_noclf_max"], "ll_qp_converged_frac_clf": record[
               "ll_qp_converged_frac_clf"], "ll_qp_converged_frac_noclf":
               record["ll_qp_converged_frac_noclf"],
               "source": "docs/CLF_LOOP.json (per-agent loop, 400 stand "
                         "ticks and 6 domains, float64)"}, "device": smi}
    for d in ("f64", "f32"):
        on, off = ({key.split(".", 2)[2]: v for key, v in clf.items()
                    if key.startswith(f"{d}.{tag}.")} for tag in ("on",
                                                                  "off"))
        rec[d] = {"com_dist_max": float(np.abs(on["com_hist"]
                                               - off["com_hist"]).max()),
                  "ll_qp_ok_clf": float(on["qp_ok"].mean()),
                  "ll_qp_ok_noclf": float(off["qp_ok"].mean()),
                  "finite": bool(np.isfinite(on["q"]).all()
                                 and np.isfinite(off["q"]).all())}
    rec["bound"] = "finite; float64 COM distance on/off <= 1e-3 m"
    rec["ok"] = (rec["f64"]["finite"] and rec["f32"]["finite"]
                 and rec["f64"]["com_dist_max"] <= 1e-3)
    emit(rec)
    check(rec["ok"], f"disturbance, CLF on/off: {rec}")
    emit({"phase": "disturbance", "seconds": time.perf_counter() - t_phase,
          "side_runs_s": {"dist": dist["seconds"], "clf": clf["seconds"]}})
    return launches


def velocity_phase(dev, smi, w, vel_ker, vel_plain):
    """Phase 18 (velocity_gait): run_velocity_gait(WALK) at B = WB_BATCH
    float32 on the whole-body phase's lanes (`w`), the reduced LL build
    with 5 Ruiz sweeps, backend "fused"; and the side processes' float64
    runs of every gait through the kernels (`vel_ker`) and the plain
    versions (`vel_plain`). Returns the kernels' launches."""
    from srbx_torch.config import Gait
    from srbx_torch.ops import pallas_linalg as plin, qp_batch, qp_fused, spd
    from srbx_torch.sim import closedloop

    t_phase = time.perf_counter()
    f32 = torch.float32
    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}
    for out in (vel_ker, vel_plain):
        check(out["ok"], f"the velocity-gait side runs failed: {out}")
    stand, walk = VEL_DEPTH
    ticks = stand + walk
    run_gait(w, "WALK", f32, WB_BATCH, 2, 2)                   # warm-up
    torch.cuda.synchronize()
    shapes = {}

    def count_shape(*a):
        key = (a[1].shape[1], a[2].shape[1])
        shapes[key] = shapes.get(key, 0) + 1

    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(qp_batch, "solve", outer_solves(count_shape)):
        res = run_gait(w, "WALK", f32, WB_BATCH, stand, walk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    expect = {"K1a": 0, "K1b": ticks, "K2a": 2 * ticks, "K2b": 2 * ticks,
              "K3a": 0, "K3b": 0}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.qp_ok))
    z = res.com_hist[:, :, 2]
    # from the first WALK tick's COM to the last
    advance = (res.com_hist[:, -1, 0] - res.com_hist[:, 0, 0]).double()
    domains = res.domains
    rec = {"phase": "velocity_gait", "gait": "WALK", "lanes": WB_BATCH,
           "dtype": "float32", "backend": "fused",
           "config": ("tests/test_wholebody.py:199-236: MotionConfig("
                      "fwd_speed=0.15), QpConfig(abstol=2e-3, reltol=1e-4, "
                      "reg 1e-6, max_iters=12), reduced LL build (5 Ruiz "
                      "sweeps in float32)"),
           "cut": (f"{stand} stand ticks and {walk} WALK ticks against the "
                   "JAX test's 400 and 2000 at 2 lanes; the whole-body "
                   "phase's lanes"),
           "ticks_per_lane": ticks, "wall_s": wall,
           "ll_ticks_per_s": WB_BATCH * ticks / wall,
           "ms_per_tick": wall * 1e3 / ticks,
           "ll_qp_ok": res.qp_ok.double().mean().item(),
           "ll_qp_ok_min": res.qp_ok.min().item(),
           "walk_com_z_min": z.min().item(),
           "domains_min": int(domains.min()), "domains_max": int(
               domains.max()),
           "x_advance_m_p50": advance.median().item(),
           "x_advance_m_min": advance.min().item(),
           "x_advance_m_max": advance.max().item(),
           "des_vel_x_max": res.agent.planner.des_vel[:, 0].max().item(),
           "ll_qp_shapes": {f"{n}_{me}": c for (n, me), c in shapes.items()},
           "launches": launches, "expected_launches": expect,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bound": ("finite; COM z > 0.25 m on every lane over the WALK "
                     "ticks; LL qp_ok >= 0.95 on every lane; domains >= 2 "
                     "on every lane; every LL QP at (25, 12); a tick "
                     "launches K1b once, K2a and K2b twice, no K1a or K3"),
           "device": smi}
    rec["ok"] = (finite and rec["walk_com_z_min"] > 0.25
                 and rec["ll_qp_ok_min"] >= 0.95 and rec["domains_min"] >= 2
                 and shapes == {(25, 12): ticks} and launches == expect)
    emit(rec)
    check(rec["ok"], f"velocity gait: {rec}")

    # where a tick's time goes: 5 WALK ticks on from the run's end
    motion_cfg = dataclasses.replace(w.motion_cfg, fwd_speed=0.15)
    ll_qp_cfg = closedloop._resolve_ll_qp_cfg(vel_qp_cfg(), True, None, f32)

    def run5():
        closedloop._gait_ticks(w.ll_cfg, motion_cfg, ll_qp_cfg, w.sim_cfg,
                               w.model, Gait.WALK, res.sim, res.agent,
                               range(ticks, ticks + 5), "fused", True)

    with qp_batch.full_f32_products():
        run5()
        pwall, busy, by_name = device_profile(run5)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "velocity_gait", "what": "profile", "ticks": 5,
          "lanes": WB_BATCH, "wall_ms_profiled": pwall * 1e3,
          "device_busy_ms": busy, "idle_share": 1.0 - busy / (pwall * 1e3),
          "top_kernels_ms": top, "device": smi})
    del res

    # every gait in float64 through the kernels and the plain versions
    worst = {}
    for gait, (backend, reduced) in VEL_FORMS.items():
        k, p = ({key.split(".", 1)[1]: v for key, v in out.items()
                 if key.startswith(gait + ".")}
                for out in (vel_ker, vel_plain))
        worst[gait] = {
            "backend": backend, "ll": "reduced" if reduced else "full",
            "max_abs_dq": float(np.abs(k["q"] - p["q"]).max()),
            "max_abs_dcom": float(np.abs(k["com_hist"]
                                         - p["com_hist"]).max()),
            "qp_ok_equal": bool(np.array_equal(k["qp_ok"], p["qp_ok"])),
            "domains_equal": bool(np.array_equal(k["domains"],
                                                 p["domains"])),
            "domains_max": int(k["domains"].max()),
            "finite": bool(np.isfinite(k["q"]).all())}
    rec = {"phase": "velocity_gait", "what": "float64 kernels vs plain",
           "lanes": WB_CROSS_LANES, "ticks": list(VEL_CROSS),
           "ll_qp_cfg": ("the reduced build with 5 Ruiz sweeps, the full "
                         "one raw"), "gaits": worst,
           "bound": ("per gait: finite, q and COM within 1e-9, qp_ok and "
                     "domains equal; POSE's domains <= 1"), "device": smi}
    rec["ok"] = (all(g["finite"] and g["qp_ok_equal"] and g["domains_equal"]
                     and max(g["max_abs_dq"], g["max_abs_dcom"]) <= 1e-9
                     for g in worst.values())
                 and worst["POSE"]["domains_max"] <= 1)
    emit(rec)
    check(rec["ok"], f"velocity gait, kernels vs plain: {rec}")
    emit({"phase": "velocity_gait",
          "seconds": time.perf_counter() - t_phase,
          "side_runs_s": {"kernels": vel_ker["seconds"],
                          "plain": vel_plain["seconds"]}})
    return launches


def per_agent_phase(dev, smi, w, run1, team1):
    """Phase 19 (per_agent): the per-agent path, which runs no kernel.
    (1), (2): the side processes' float64 runs (`run1`: closedloop.run
    against run_batch("xla") at B 1; `team1`: run_team against
    run_team_batch("xla") at S 1) held to their JAX tests' bounds; (3)
    run_team at the paper's configuration (tests/test_team.py:15-48:
    MpcConfig(use_sqp=True, sqp_iters=2), QpConfig(), the full LL build),
    two agents 1.2 m apart, float32, over AGENT_PAPER: ms a tick, the IPM
    iterations of the NMPC's and the LL's QPs, a profile of
    AGENT_PROFILE_TICKS trot ticks, and the checks: no kernel launched,
    both agents standing, every CBF margin >= cbf_eps - 1e-3, LL qp_ok >=
    AGENT_F32_LL_OK. `w`: the whole-body phase's model and configurations.
    Returns the kernels' launches over (3)."""
    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch.ops import pallas_linalg as plin, qp, qp_batch, qp_fused
    from srbx_torch.ops import spd
    from srbx_torch.sim import closedloop

    t_phase = time.perf_counter()
    for out in (run1, team1):
        check(out["ok"], f"the per-agent side runs failed: {out}")
    # (1) run against run_batch("xla"), one agent
    rec = {"phase": "per_agent", "what": "run vs run_batch xla, float64",
           "config": "tests/test_wholebody.py:165-199 (lane 0)",
           "ticks": list(AGENT_RUN),
           "cut": "200 stand ticks to 100",
           "max_abs_dq": float(np.abs(run1["run.q"]
                                      - run1["batch.q"]).max()),
           "max_abs_dcom": float(np.abs(run1["run.com_hist"]
                                        - run1["batch.com_hist"]).max()),
           "d_qp_ok": abs(run1["run.qp_ok"] - run1["batch.qp_ok"]),
           "d_mpc_ok": abs(run1["run.mpc_ok"] - run1["batch.mpc_ok"]),
           "qp_ok": run1["run.qp_ok"], "mpc_ok": run1["run.mpc_ok"],
           "run_s": run1["run_s"], "batch_s": run1["batch_s"],
           "run_ms_per_tick": run1["run_s"] * 1e3 / (
               AGENT_RUN[0] + AGENT_RUN[1] * AGENT_RUN[2]),
           "bound": "q and COM within 1e-8, qp_ok and mpc_ok within 1e-12",
           "device": smi}
    rec["ok"] = (max(rec["max_abs_dq"], rec["max_abs_dcom"]) <= 1e-8
                 and max(rec["d_qp_ok"], rec["d_mpc_ok"]) <= 1e-12
                 and bool(np.isfinite(run1["run.q"]).all()))
    emit(rec)
    check(rec["ok"], f"per-agent run vs run_batch: {rec}")
    # (2) run_team against run_team_batch("xla"), two agents
    rec = {"phase": "per_agent",
           "what": "run_team vs run_team_batch xla, float64",
           "config": "tests/test_team.py:50-100", "ticks": list(AGENT_TEAM),
           "cut": "150 stand ticks to 100",
           "max_abs_dcom": float(np.abs(team1["run.com_ends"]
                                        - team1["batch.com_ends"]).max()),
           "max_abs_dmargin": float(np.abs(team1["run.margins"]
                                           - team1["batch.margins"]).max()),
           "llok_batch_mean": float(team1["batch.llok"].mean()),
           "llok_run_min": float(team1["run.llok"].min()),
           "run_s": team1["run_s"], "batch_s": team1["batch_s"],
           "bound": "COM within 2e-3, margins within 1e-2, llok > 0.95",
           "device": smi}
    rec["ok"] = (rec["max_abs_dcom"] <= 2e-3 and rec["max_abs_dmargin"]
                 <= 1e-2 and rec["llok_batch_mean"] > 0.95
                 and bool(np.isfinite(team1["run.com_ends"]).all()))
    emit(rec)
    check(rec["ok"], f"per-agent run_team vs run_team_batch: {rec}")

    # (3) the paper's team, float32
    f32 = torch.float32
    cfg = MpcConfig(use_sqp=True, sqp_iters=2)
    p_start = [0.0, 0.6, 0.0, -0.6]
    traj, pobs = _agent_reference(p_start, 4_000, dev, f32)
    pr, prd = traj.pr.reshape(2, 2, -1), traj.prd.reshape(2, 2, -1)
    a0 = torch.tensor(p_start, dtype=f32, device=dev).reshape(2, 2)

    def team(depth):
        return closedloop.run_team(
            cfg, w.ll_cfg, w.motion_cfg, QpConfig(), w.sim_cfg,
            closedloop.LoopConfig(*depth), w.model, pr, prd, a0, pobs,
            dtype=f32, device=dev)

    counters = {"K1a": qp_fused.solve_lanes_last, "K1b": qp_fused.solve,
                "K2a": spd.solve, "K2b": spd.inverse,
                "K3a": plin.batch_cholesky, "K3b": plin.batch_cho_solve}
    team((1, 1, 1))                                          # warm-up
    torch.cuda.synchronize()
    iters = []                       # (n, iterations of each lane)
    solve = qp.solve

    def recorded(*a, **k):
        sol = solve(*a, **k)
        iters.append((a[0].shape[-1], sol.iters))
        return sol

    ends = []
    trot = closedloop._trot_domain

    def trot_kept(*a, **k):
        out = trot(*a, **k)
        ends.append(out[:2])
        return out

    for k in counters.values():
        k.launches = 0
    stand, n_dom, per = AGENT_PAPER
    ticks = stand + n_dom * per
    t0 = time.perf_counter()
    with mock.patch.object(qp, "solve", recorded), \
            mock.patch.object(closedloop, "_trot_domain", trot_kept):
        sims, _, margins, llok = team(AGENT_PAPER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    q = sims.q.double().cpu().numpy()
    by_n = {}
    for n, it in iters:
        by_n.setdefault(n, []).extend(it.tolist())

    def spread(v):
        v = np.asarray(v, np.float64)
        return {"qps": int(v.size), "min": int(v.min()),
                "p50": float(np.median(v)), "mean": float(v.mean()),
                "max": int(v.max())}

    sep = float(np.linalg.norm(q[0, 0:2] - q[1, 0:2]))
    rec = {"phase": "per_agent", "what": "run_team, the paper's "
           "configuration, float32", "agents": 2,
           "config": ("tests/test_team.py:15-48: MpcConfig(use_sqp=True, "
                      "sqp_iters=2) (uncondensed, n 41 / me 28, SCP mi 116 "
                      "with the neighbour), QpConfig(), the full LL build "
                      "(n 43 / me 30), LU inverses, no kernel"),
           "ticks": list(AGENT_PAPER),
           "cut": ("800 stand ticks and 8 domains to 100 and 1; the "
                   "reference of 4000 planner steps, not 20,000"),
           "wall_s": wall, "ms_per_tick": wall * 1e3 / ticks,
           "robot_ticks_per_s": 2 * ticks / wall,
           "nmpc_qp_iters": spread(by_n.get(cfg.num_dec, [])),
           "ll_qp_iters": spread(by_n.get(43, [])),
           "qp_shapes": {n: len(v) for n, v in by_n.items()},
           "ll_qp_ok": float(llok.min()), "margin_min": float(margins.min()),
           "separation": sep, "z": q[:, 2].tolist(),
           "roll_pitch_max": float(np.abs(q[:, 3:5]).max()),
           "launches": launches,
           "expected_launches": {k: 0 for k in counters},
           "bound": ("no kernel launched; both agents finite, |z - 0.28| < "
                     "0.03 m, roll and pitch < 0.15 rad; margins >= cbf_eps "
                     f"- 1e-3; LL qp_ok >= {AGENT_F32_LL_OK} (float32 under "
                     "QpConfig(): the JAX package's own share 0.860)"),
           "device": smi}
    rec["ok"] = (launches == rec["expected_launches"]
                 and bool(np.isfinite(q).all())
                 and float(np.abs(q[:, 2] - 0.28).max()) < 0.03
                 and rec["roll_pitch_max"] < 0.15
                 and rec["margin_min"] >= cfg.cbf_eps - 1e-3
                 and rec["ll_qp_ok"] >= AGENT_F32_LL_OK)
    emit(rec)
    check(rec["ok"], f"per-agent team: {rec}")

    # where a tick's time goes: trot ticks on from the run's end
    loop5 = closedloop.LoopConfig(0, 1, AGENT_PROFILE_TICKS)
    end_sims, end_asts = ends[-1]

    def run5():
        closedloop._trot_domain(w.ll_cfg, w.motion_cfg, QpConfig(),
                                w.sim_cfg, loop5, w.model, end_sims,
                                end_asts, closedloop.PER_AGENT, False)

    with qp_batch.full_f32_products():
        run5()
        pwall, busy, by_name = device_profile(run5)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "per_agent", "what": "profile",
          "ticks": AGENT_PROFILE_TICKS, "agents": 2,
          "wall_ms_profiled": pwall * 1e3, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / (pwall * 1e3), "top_kernels_ms": top,
          "device": smi})
    emit({"phase": "per_agent", "seconds": time.perf_counter() - t_phase,
          "side_runs_s": {"run": run1["seconds"], "team": team1["seconds"]}})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "srbx_torch").is_dir():
        print(f"chip_smoke: no srbx_torch/ beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from srbx_torch.config import MpcConfig, QpConfig
    from srbx_torch import convert, mpc, mpc_batch, refplan
    from srbx_torch.ops import _build, qp_fused

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ------------------------------ 1. probe ------------------------------ #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "probe", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------ 2. build ------------------------------ #
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.is_file() else [])
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    # the fused IPMs', K2's and K3's float32 builds must not spill (the "If"
    # in the mangled name is the float instantiation)
    k1_ptxas = {name: ptxas_summary(log.read_text(), name) for name in (
        "qp_fused_noeq_kernel", "qp_general_kernel")}
    k3_ptxas = {name: ptxas_summary(log.read_text(), name) for name in (
        "cholesky_kernel", "cho_solve1_kernel", "cho_solve_kernel")}
    k2_ptxas = ptxas_summary(log.read_text(), "spd_lane_kernel")
    f32_spills = sum(e["spill_stores"] + e["spill_loads"]
                     for es in k1_ptxas.values() for e in es
                     if "kernelIf" in e["entry"])
    k3_f32_spills = sum(e["spill_stores"] + e["spill_loads"]
                        for es in k3_ptxas.values() for e in es
                        if "kernelIf" in e["entry"])
    k2_f32_spills = sum(e["spill_stores"] + e["spill_loads"]
                        for e in k2_ptxas if "kernelIf" in e["entry"])
    warps = {f"{k}_{d}_mi{mi}": qp_fused.resident_warps(dt, mi, k != "K1a",
                                                        shape)
             for k, mis, shape in (("K1a", (28, 48, 52, 92, 112, 116), None),
                                   ("K1b", (45,), (43, 30)),
                                   ("K1b_25_12", (45,), (25, 12)),
                                   ("K1b_41_28", (92, 112, 116), (41, 28)),
                                   ("K1b_17_4", (28, 48, 52, 92, 112, 116),
                                    (17, 4)))
             for d, dt in (("f32", torch.float32), ("f64", torch.float64))
             for mi in mis}
    # the other kernels at their paths' shapes, float32
    for name, fn, shapes in (
            ("K2", _build.load().srbx_spd_resident_warps,
             ((18, 1), (18, 0), (12, 0))),
            ("K3", _build.load().srbx_pallas_resident_warps,
             ((41, 0), (28, 0), (41, 28), (41, 1), (28, 1)))):
        for k, r in shapes:
            warps[f"{name}_f32_k{k}_r{r}"] = fn(0, k, r)
    from srbx_torch.ops import pallas_linalg as plin, spd
    k3_geometry = {f"{d}_k{k}_r{r}": plin.launch_geometry(dt, k, r, BATCH)
                   for d, dt in (("f32", torch.float32),
                                 ("f64", torch.float64))
                   for k, r in ((41, 0), (28, 0), (41, 28), (41, 1), (28, 1))}
    # K2 at the whole-body path's shapes (r 0: the inverse)
    k2_geometry = {f"{d}_k{k}_r{r}": spd.launch_geometry(dt, k, r, WB_BATCH)
                   for d, dt in (("f32", torch.float32),
                                 ("f64", torch.float64))
                   for k, r in ((18, 1), (18, 0), (12, 0))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), "ptxas": ptxas,
          "k1_ptxas": k1_ptxas, "k1_f32_spill_bytes": f32_spills,
          "k3_ptxas": k3_ptxas, "k3_f32_spill_bytes": k3_f32_spills,
          "k2_ptxas": k2_ptxas, "k2_f32_spill_bytes": k2_f32_spills,
          "resident_warps_per_sm": warps, "k3_geometry": k3_geometry,
          "k2_geometry": k2_geometry})
    check(f32_spills == 0 and all(k1_ptxas.values()),
          f"the fused IPMs' float32 builds spill: {k1_ptxas}")
    check(k3_f32_spills == 0 and all(k3_ptxas.values()),
          f"K3a or K3b's float32 builds spill: {k3_ptxas}")
    check(k2_f32_spills == 0 and k2_ptxas,
          f"K2a or K2b's float32 builds spill: {k2_ptxas}")

    cfg = MpcConfig(use_sqp=True, sqp_iters=2, elide_box_rows=True,
                    elide_simplex=True)
    # the benchmark's two solver configurations (bench.py)
    relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                       reg_dual=1e-6, max_iters=12, kkt_refine_iters=0)
    strict = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                      reg_dual=1e-6, max_iters=25)

    f32 = torch.float32
    t0 = time.perf_counter()
    inputs, p_start, pobs = benchmark_inputs(dev)
    refplan_s = time.perf_counter() - t0

    def lanes(dtype, count=BATCH):
        return lanes_of(inputs, dev, dtype, count)

    def cycle(args, qp_cfg, **kw):
        return mpc_batch.run_nmpc_batch(cfg, qp_cfg, *args, backend="fused",
                                        condensed=True, **kw)

    # ------------------------- 3. kernel vs plain ------------------------- #
    def bench_qps(dtype):
        return nmpc_cycle_qps(cfg, strict, inputs, p_start, pobs, dev, dtype)

    # In float32 the kernel and its plain version round differently. Where
    # all four legs stand (every benchmark lane: domain 0) the condensed P
    # is singular, because how the stance legs share the load does not enter
    # the cost, so that share (in x) drifts with rounding while the planned
    # trajectory does not. The float32 check therefore bounds the trajectory
    # x_full[:24] = (states, inputs) = e0 + E x, and reports x unchecked.
    n_traj = (cfg.n_state + cfg.n_input) * cfg.horizon
    f64_max_dx = 0.0
    launches0 = qp_fused.solve_lanes_last.launches
    n_compared = 0
    for dtype, configs in ((torch.float64, (("strict", strict),)),
                           (f32, (("relaxed", relaxed),
                                            ("strict", strict)))):
        qp, cases = bench_qps(dtype)
        if dtype == torch.float64:
            qp64, cases64 = qp, cases
        for cfg_name, qp_cfg in configs:
            for case, G, h, x0 in cases:
                xk, zk, sk, stk = qp_fused.solve_lanes_last(
                    qp.P, qp.c, G, h, qp_cfg, x0=x0)
                xp, zp, sp, stp = qp_fused.solve_lanes_last_plain(
                    qp.P, qp.c, G, h, qp_cfg, x0=x0)
                torch.cuda.synchronize()
                n_compared += 1
                conv_k, conv_p = stk[2] > 0.5, stp[2] > 0.5
                traj_k = mpc_batch.expand_ll(qp, xk)[:, :n_traj]
                traj_p = mpc_batch.expand_ll(qp, xp)[:, :n_traj]
                dtraj = (traj_k - traj_p).abs()
                rec = {"phase": "kernel", "case": case, "dtype": str(dtype),
                       "config": cfg_name, "mi": G.shape[0], "lanes": BATCH,
                       "max_abs_dx": (xk - xp).abs().max().item(),
                       "max_abs_dz": (zk - zp).abs().max().item(),
                       "max_abs_ds": (sk - sp).abs().max().item(),
                       "max_abs_dtraj": dtraj.max().item(),
                       "converged_kernel": conv_k.double().mean().item(),
                       "converged_plain": conv_p.double().mean().item(),
                       "max_iters_kernel": stk[3].max().item(),
                       "max_iters_plain": stp[3].max().item()}
                if dtype == torch.float64:
                    # the same arithmetic in another order: rounding only
                    rec["bound"] = ("max|dx| <= 1e-9; same converged lanes; "
                                    "equal max iterations")
                    f64_max_dx = max(f64_max_dx, rec["max_abs_dx"])
                    ok = (rec["max_abs_dx"] <= 1e-9
                          and bool((conv_k == conv_p).all())
                          and rec["max_iters_kernel"] == rec["max_iters_plain"])
                else:
                    both = conv_k & conv_p
                    rel = (dtraj / traj_p.abs().clamp(min=1.0))[both]
                    rec["max_rel_dtraj_converged"] = (rel.max().item()
                                                      if rel.numel() else 0.0)
                    rec["bound"] = ("lanes converged in both: trajectory "
                                    "|d| <= 1e-3 max(1,|traj|); kernel "
                                    "converged share >= plain's - 0.5 "
                                    "points; equal max iterations")
                    ok = (rec["max_rel_dtraj_converged"] <= 1e-3
                          and rec["converged_kernel"]
                          >= rec["converged_plain"] - 0.005
                          and rec["max_iters_kernel"] == rec["max_iters_plain"])
                rec["ok"] = ok
                emit(rec)
                check(ok, f"kernel disagrees with its plain version: {rec}")
    check(qp_fused.solve_lanes_last.launches - launches0 == n_compared,
          "the kernel's launch counter did not advance once per solve")

    # A ragged batch (B - 5 lanes: the last block part full) whose blocks
    # mix lanes that converge in a few iterations, infeasible lanes that run
    # to max_iters and one lane that is non-finite from its start. Each
    # lane stops on its own; none may change another's result.
    mixed_cfg = QpConfig(abstol=1e-6, reltol=1e-6, reg_primal=1e-6,
                         reg_dual=1e-6, max_iters=12)
    cut = BATCH - 5
    _, g_mix, h_mix, x_mix = cases64[1]
    ops = [t[..., :cut].clone(memory_format=torch.contiguous_format)
           for t in (qp64.P, qp64.c, g_mix, h_mix)]
    infeasible = make_mixed(ops[2].permute(2, 0, 1), ops[3].T)
    x_mix = x_mix[:, :cut].contiguous()
    outs = [fn(*ops, mixed_cfg, x0=x_mix) for fn in (
        qp_fused.solve_lanes_last, qp_fused.solve_lanes_last_plain)]
    torch.cuda.synchronize()
    fin = [torch.isfinite(x).all(0) & torch.isfinite(z).all(0)
           & torch.isfinite(sl).all(0) for x, z, sl, _ in outs]
    mixed_record("K1a", cut, outs[0][0].T, outs[1][0].T, *fin,
                 outs[0][3][2] > 0.5, outs[1][3][2] > 0.5, outs[0][3][3],
                 outs[1][3][3], infeasible, 7, mixed_cfg.max_iters)
    del qp64, cases64, ops, outs

    # ------------------------------ 4. slice ------------------------------ #
    args = lanes(f32)
    cycle(args, relaxed)                       # warm-up: lazy init, caches
    torch.cuda.synchronize()
    qp_fused.solve_lanes_last.launches = 0
    out = cycle(args, relaxed)
    torch.cuda.synchronize()
    slice_launches = qp_fused.solve_lanes_last.launches
    check(slice_launches == 1 + cfg.sqp_iters,
          f"{slice_launches} fused-IPM launches in one cycle, expected 3")
    for name in ("alpha_com", "states", "inputs", "x", "cbf_margin"):
        t = getattr(out, name)
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(tuple(out.states.shape) == (BATCH, cfg.horizon, 4)
          and tuple(out.alpha_com.shape) == (BATCH, 4, 5),
          "unexpected output shapes")

    # the first lanes against the plain path (the same cycle with the fused
    # IPM's plain PyTorch version) in float64 on the card
    args64 = lanes(torch.float64, CROSS_LANES)

    def plain_solve(P, c, G, h, qp_cfg, x0=None):
        return qp_fused.solve_lanes_last_plain(P, c, G, h, qp_cfg, x0=x0)

    with mock.patch.object(qp_fused, "solve_lanes_last", plain_solve):
        ref64 = cycle(args64, relaxed)
    ker64 = cycle(args64, relaxed)
    torch.cuda.synchronize()

    def maxdiff(a, b):
        a, b = convert.to_numpy((a, b))
        return float(np.abs(a.astype(np.float64) - b).max())

    cross = {
        "phase": "slice", "lanes": BATCH, "dtype": "float32",
        "config": "relaxed", "launches": slice_launches,
        "refplan_seconds": refplan_s,
        "converged": out.qp_converged.double().mean().item(),
        "qp_iters": int(out.qp_iters),
        "f64_kernel_vs_plain_states": maxdiff(ker64.states, ref64.states),
        "f64_kernel_vs_plain_alpha_com": maxdiff(ker64.alpha_com,
                                                 ref64.alpha_com),
        "f32_vs_f64_plain_states": maxdiff(out.states[:CROSS_LANES],
                                           ref64.states),
        "f32_vs_f64_plain_alpha_com": maxdiff(out.alpha_com[:CROSS_LANES],
                                              ref64.alpha_com),
        "f32_vs_f64_plain_qp_converged_equal": bool(
            (out.qp_converged[:CROSS_LANES] == ref64.qp_converged).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    # f64 kernel path against f64 plain path: rounding only, so 1e-9.
    # f32 kernel path against f64 plain path: each stops inside the relaxed
    # tolerance at its own point. 1e-3 (1 mm on the planned COM knots and
    # their Bezier coefficients) is far below what the robot tracks and
    # catches a wrong plan, whose knots move by centimetres or more.
    cross["bound"] = "f64 paths 1e-9; f32 vs f64 states and alpha_com 1e-3"
    cross["ok"] = (cross["f64_kernel_vs_plain_states"] <= 1e-9
                   and cross["f64_kernel_vs_plain_alpha_com"] <= 1e-9
                   and cross["f32_vs_f64_plain_states"] <= 1e-3
                   and cross["f32_vs_f64_plain_alpha_com"] <= 1e-3)
    emit(cross)
    check(cross["ok"], f"slice cross-check failed: {cross}")

    # ------------------------------ 5. times ------------------------------ #
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        out = cycle(args, qp_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = cycle(args, qp_cfg)
        torch.cuda.synchronize()
        pipelined = BATCH * REPS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = cycle(args, qp_cfg)
            torch.cuda.synchronize()
        synced = BATCH * REPS / (time.perf_counter() - t0)
        emit({"phase": "times", "what": "cycle", "config": cfg_name,
              "lanes": BATCH, "dtype": "float32", "reps": REPS,
              "cycles_per_s_pipelined": pipelined,
              "cycles_per_s_synced": synced,
              "converged": out.qp_converged.double().mean().item(),
              "qp_iters": int(out.qp_iters), "device": smi})

    qp, cases = bench_qps(f32)
    k1_ms, k1_stat = {}, {}
    for case, G, h, x0 in cases:                # mi 28 cold, mi 48 / 52 warm
        def kern():
            return qp_fused.solve_lanes_last(qp.P, qp.c, G, h, relaxed,
                                             x0=x0)

        def plain():
            return qp_fused.solve_lanes_last_plain(qp.P, qp.c, G, h, relaxed,
                                                   x0=x0)

        k1_stat[case] = kern()[3]
        plain()
        # in turns on one card: plain, kernel, kernel, plain
        p1 = event_ms(plain, 3)
        k1 = event_ms(kern, REPS)
        k2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        k1_ms[case] = ((k1 + k2) / 2, (p1 + p2) / 2)
        emit({"phase": "times", "what": "fused_ipm", "case": case,
              "mi": G.shape[0], "lanes": BATCH, "dtype": "float32",
              "config": "relaxed", "kernel_ms": [k1, k2],
              "plain_ms": [p1, p2], "device": smi})

    # the row reports the cycle's warm SCP solve (mi 48), and each case
    k1a_cases = {}
    for case, G, h, x0 in cases:
        k1a_cases[case] = dict(
            mi=G.shape[0], ms=k1_ms[case][0], plain_ms=k1_ms[case][1],
            **bound(*k1a_work(qp.P, qp.c, G, h, x0, k1_stat[case][3],
                              relaxed.kkt_refine_iters)))
    main_case = dict(k1a_cases["warm_mi48"])
    del main_case["mi"]
    kernels = [dict(
        name="qp_fused_noeq", route="cuda",
        source="srbx_torch/csrc/qp_fused.cu",
        replaces="srbx/ops/qp_fused.py:94",
        launches=slice_launches, max_abs_err=f64_max_dx,
        **main_case, library_ms=None,
        launches_by_path={"nmpc_cycle": slice_launches},
        by_case=k1a_cases)]

    # ------------------- 6. whole-body kernels vs plain ------------------- #
    from srbx_torch import agent, motion
    from srbx_torch.config import Gait, LowLevelConfig, MotionConfig
    from srbx_torch.estimation import contact
    from srbx_torch.lowlevel import swing_delta_inv
    from srbx_torch.models import a1, rbd
    from srbx_torch.ops import qp_batch
    from srbx_torch.sim import closedloop, wholebody as wb

    model = a1.model()
    ll_cfg, motion_cfg, sim_cfg = LowLevelConfig(), MotionConfig(), \
        wb.SimConfig()
    wb_mpc = MpcConfig(use_sqp=True, sqp_iters=1, condensed=True,
                       elide_box_rows=True, elide_simplex=True)
    # bench_wholebody's relaxed LL and NMPC solver configuration
    wb_relaxed = QpConfig(abstol=2e-3, reltol=1e-4, reg_primal=1e-6,
                          reg_dual=1e-6, max_iters=12)
    # the loop of the kernel checks' states (a 172-tick TROT domain after
    # a 200-tick stand) and the timed run's, cut to WB_DEPTH
    wb_loop = closedloop.LoopConfig(stand_ticks=200, n_domains=1,
                                    ticks_per_domain=172)
    wb_run = closedloop.LoopConfig(*WB_DEPTH)
    wb_ticks = wb_run.stand_ticks + wb_run.n_domains * wb_run.ticks_per_domain
    wb_a0 = p_start[:2] + np.linspace(0.0, 0.01, WB_BATCH)[:, None] * \
        np.array([1.0, 0.0])
    wb_pobs = np.full((WB_BATCH, 2, 20), 100.0)
    wb_ref = refplan.generate(
        refplan.two_agent_config(loop_size=4_000),
        torch.tensor(p_start, dtype=f32, device=dev),
        torch.tensor(wb_pobs[0], dtype=f32, device=dev), dtype=f32,
        device=dev)
    wb_pr = wb_ref.pr[0:2].expand(WB_BATCH, -1, -1)
    wb_prd = wb_ref.prd[0:2].expand(WB_BATCH, -1, -1)

    def wb_states(dtype):
        """Stand and trot states of the loop at B = 4096: the crouched start
        with joints, base angles and rates spread by numpy noise; the trot
        lanes in alternating diagonal domains at every phase of a domain,
        their MPC Bezier holding position."""
        rng = np.random.default_rng(4)
        sims, stand, _ = closedloop._init_lanes(
            motion_cfg, wb_loop, model,
            torch.tensor(wb_a0, dtype=dtype, device=dev), dtype)
        noise = np.zeros((WB_BATCH, 18))
        noise[:, 3:6] = rng.normal(size=(WB_BATCH, 3)) * 0.03
        noise[:, 6:] = rng.normal(size=(WB_BATCH, 12)) * 0.1
        q = sims.q + torch.tensor(noise, dtype=dtype, device=dev)
        qd = torch.tensor(rng.normal(size=(WB_BATCH, 18)) * 0.2, dtype=dtype,
                          device=dev)
        lane = torch.arange(WB_BATCH, device=dev)
        des = torch.where((lane % 2 == 0)[:, None],
                          motion.next_trot_domain(stand.con.des),
                          1 - motion.next_trot_domain(stand.con.des))
        hold = torch.stack([q[:, 0], torch.zeros_like(q[:, 0]), q[:, 1],
                            torch.zeros_like(q[:, 0])], 1)
        trot = stand._replace(
            loco_tick=(lane % wb_loop.ticks_per_domain).to(dtype),
            gait_domain=torch.full_like(stand.gait_domain, 2),
            con=contact.set_des_domain(stand.con, des),
            planner=stand.planner._replace(
                dom_ticks=torch.full_like(stand.planner.dom_ticks, 172.0),
                des_domain=des.to(torch.int32)),
            mpc_alpha=hold[:, :, None].expand(-1, -1, 5).contiguous(),
            mpc_available=torch.ones_like(stand.mpc_available))
        forces = wb.foot_force_measurement(sim_cfg, model, wb.SimState(q, qd))
        out = {}
        for name, gait, st in (("stand", Gait.STAND, stand),
                               ("trot", Gait.TROT, trot)):
            d = rbd.mass_matrix(model, q)
            data, ctx = agent.tick_build(
                ll_cfg, motion_cfg, model, gait, st, q, qd, forces,
                allow_contact_trigger=False, d_inv=spd.inverse_plain(d))
            out[name] = (data, d, swing_delta_inv(ctx.ll_ctx),
                         -rbd.bias_forces(model, q, qd))
        return out

    def k1b_record(case, dtype, cfg_name, data, sk, sp):
        dx = (sk.x - sp.x).abs()
        return {"phase": "wb_kernel", "kernel": "K1b qp_general",
                "case": case, "dtype": str(dtype), "config": cfg_name,
                "lanes": WB_BATCH, "n": data[1].shape[1],
                "me": data[2].shape[1], "mi": data[4].shape[1],
                "max_abs_dx": dx.max().item(),
                "max_abs_dy": (sk.y - sp.y).abs().max().item(),
                "converged_kernel": sk.converged.double().mean().item(),
                "converged_plain": sp.converged.double().mean().item(),
                "converged_equal": (sk.converged == sp.converged)
                .double().mean().item(),
                "lane_iters_equal": (sk.lane_iters == sp.lane_iters)
                .double().mean().item(),
                "max_iters_kernel": int(sk.iters),
                "max_iters_plain": int(sp.iters)}

    # K1b's arithmetic: random QPs at the LL QP's shape (n 43, me 30,
    # mi 45), well conditioned (diagonal P in [0.1, 10], a strictly
    # feasible point), where the kernel and its plain version differ by
    # rounding only: max|dx| <= 1e-9 with equal flags and per-lane
    # iterations, in float64.
    rand_qp = random_ll_qps(WB_BATCH, dev, torch.float64)

    wb_counts = (qp_fused.solve, spd.solve, spd.inverse)
    counts0 = [k.launches for k in wb_counts]
    sk = qp_fused.solve(*rand_qp, QpConfig())
    sp = qp_fused.solve_plain(*rand_qp, QpConfig())
    torch.cuda.synchronize()
    rec = k1b_record("random", torch.float64, "strict", rand_qp, sk, sp)
    rec["bound"] = ("max|dx| <= 1e-9; equal converged flags and per-lane "
                    "iterations")
    rec["ok"] = (rec["max_abs_dx"] <= 1e-9 and rec["converged_equal"] == 1.0
                 and rec["lane_iters_equal"] == 1.0)
    k1b_f64_dx = rec["max_abs_dx"]
    emit(rec)
    check(rec["ok"], f"K1b disagrees with its plain version: {rec}")

    # K1b on the loop's own LL QPs. These are badly conditioned (in the
    # float64 plain version alone, a 4-ulp change of h moves x by up to
    # 9e-5 on converged stand lanes and flips the converged flag of 1 lane
    # in 2048: scripts/torch_ll_qp_conditioning.py), so x is not compared. What holds: the kernel converges on
    # as many lanes as the plain version, and every lane it calls converged
    # meets the stopping test when that is recomputed in float64 from its
    # (x, y, z, s), within the recomputation's rounding (1e-6 of the limit
    # in float64, 1 % in float32).
    k2_f64_rel = {}
    wb_qps = {}
    for dtype, qp_cfg, cfg_name in ((torch.float64, QpConfig(), "strict"),
                                    (f32, wb_relaxed, "relaxed")):
        states = wb_states(dtype)
        wb_qps[dtype] = states
        slack = 1.0 + (1e-6 if dtype == torch.float64 else 1e-2)
        for case, (data, d, dinv12, rhs) in states.items():
            sk = qp_fused.solve(*data, qp_cfg)
            sp = qp_fused.solve_plain(*data, qp_cfg)
            torch.cuda.synchronize()
            rec = k1b_record(case, dtype, cfg_name, data, sk, sp)
            res, gap, gap_scale = stopping_test(data, sk)
            conv = sk.converged
            res_lim = (qp_cfg.abstol + qp_cfg.reltol) * slack
            certified = ((res <= res_lim)
                         & (gap <= qp_cfg.abstol * gap_scale * slack))[conv]
            both = conv & sp.converged
            rel = ((sk.x - sp.x)[:, 0:24].abs().amax(1)
                   / sp.x[:, 0:24].abs().amax(1).clamp(min=1.0))[both]
            rec.update({
                "certified_share_of_converged": (
                    certified.double().mean().item() if conv.any() else 1.0),
                "max_recomputed_res_converged": (
                    res[conv].max().item() if conv.any() else 0.0),
                "res_limit": qp_cfg.abstol + qp_cfg.reltol,
                "rel_dx_force_torque_both_converged": (
                    [rel.median().item(), rel.quantile(0.99).item(),
                     rel.max().item()] if rel.numel() else None),
                "bound": ("kernel converged share >= plain's - 0.5 points; "
                          "every kernel-converged lane meets the stopping "
                          f"test recomputed in float64 (x{slack:.7g})")})
            rec["ok"] = (rec["converged_kernel"]
                         >= rec["converged_plain"] - 0.005
                         and bool(certified.all()))
            emit(rec)
            check(rec["ok"], f"K1b disagrees with its plain version: {rec}")
            for kname, got, want in (
                    ("K2a spd.solve k18", spd.solve(d, rhs),
                     spd.solve_plain(d, rhs)),
                    ("K2b spd.inverse k18", spd.inverse(d),
                     spd.inverse_plain(d)),
                    ("K2b spd.inverse k12", spd.inverse(dinv12),
                     spd.inverse_plain(dinv12))):
                torch.cuda.synchronize()
                rel = ((got - want).abs().max()
                       / want.abs().max()).item()
                # the kernels keep the plain loop's arithmetic: any
                # differing bit is a fault
                rec = {"phase": "wb_kernel", "kernel": kname, "case": case,
                       "dtype": str(dtype), "lanes": WB_BATCH,
                       "max_abs_err": (got - want).abs().max().item(),
                       "max_rel_err": rel,
                       "bitwise_equal": bool(torch.equal(got, want)),
                       "finite": bool(torch.isfinite(got).all()),
                       "bound": "bitwise equal to the plain version; finite"}
                rec["ok"] = rec["bitwise_equal"] and rec["finite"]
                if dtype == torch.float64:
                    k2_f64_rel[kname] = max(k2_f64_rel.get(kname, 0.0),
                                            rec["max_abs_err"])
                emit(rec)
                check(rec["ok"], f"SPD kernel disagrees: {rec}")
    check([k.launches - c for k, c in zip(wb_counts, counts0)] == [5, 4, 8],
          "the whole-body kernels' counters did not advance once per call")

    # K1b on a ragged batch (B - 3 = 4093 lanes) of random QPs of the LL
    # QP's shape mixing converging, infeasible and one non-finite lane, as for K1a
    mix_lanes = WB_BATCH - 3
    mix_qp = random_ll_qps(mix_lanes, dev, torch.float64, seed=8)
    infeasible = make_mixed(mix_qp[4], mix_qp[5])
    sols = [fn(*mix_qp, mixed_cfg) for fn in (qp_fused.solve,
                                              qp_fused.solve_plain)]
    torch.cuda.synchronize()
    fin = [torch.isfinite(torch.cat([o.x, o.y, o.z, o.s], 1)).all(1)
           for o in sols]
    mixed_record("K1b", mix_lanes, sols[0].x, sols[1].x, *fin,
                 sols[0].converged, sols[1].converged, sols[0].lane_iters,
                 sols[1].lane_iters, infeasible, 7, mixed_cfg.max_iters)

    # ------------------------- 7. the whole-body loop ----------------------- #
    def run_wb(dtype, lanes, loop, mpc_cfg=wb_mpc):
        return closedloop.run_batch(
            mpc_cfg, ll_cfg, motion_cfg, wb_relaxed, sim_cfg, loop, model,
            wb_pr[:lanes].to(dtype), wb_prd[:lanes].to(dtype),
            torch.tensor(wb_a0[:lanes], dtype=dtype, device=dev),
            torch.tensor(wb_pobs[:lanes], dtype=dtype, device=dev),
            dtype=dtype, device=dev)

    run_wb(f32, WB_BATCH, closedloop.LoopConfig(2, 1, 2))   # warm-up
    torch.cuda.synchronize()
    all_counts = (qp_fused.solve_lanes_last,) + wb_counts
    for k in all_counts:
        k.launches = 0
    t0 = time.perf_counter()
    res = run_wb(f32, WB_BATCH, wb_run)
    torch.cuda.synchronize()
    wb_wall = time.perf_counter() - t0
    wb_launches = dict(zip(("K1a", "K1b", "K2a", "K2b"),
                           (k.launches for k in all_counts)))
    expect = {"K1a": 2 * wb_run.n_domains, "K1b": wb_ticks,
              "K2a": 2 * wb_ticks, "K2b": 2 * wb_ticks}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.qp_ok, res.mpc_ok,
        res.tau_hist))
    final_z = res.com_hist[:, -1, -1, 2]
    wb_rec = {
        "phase": "wholebody", "lanes": WB_BATCH, "dtype": "float32",
        "ticks_per_lane": wb_ticks, "stand_ticks": wb_run.stand_ticks,
        "n_domains": wb_run.n_domains,
        "ticks_per_domain": wb_run.ticks_per_domain,
        "wall_s": wb_wall, "ll_ticks_per_s": WB_BATCH * wb_ticks / wb_wall,
        "ll_qp_ok": res.qp_ok.double().mean().item(),
        "mpc_ok": res.mpc_ok.double().mean().item(),
        "final_com_z_min": final_z.min().item(),
        "final_com_z_max": final_z.max().item(),
        "launches": wb_launches, "expected_launches": expect,
        "finite": finite,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": smi,
        "bound": ("finite; final COM z > 0.2 m in every lane; exact launch "
                  "counts (the float64 kernels-vs-plain run: a line of its "
                  "own after phase 13)"),
    }
    wb_rec["ok"] = (finite and final_z.min().item() > 0.2
                    and wb_launches == expect)
    emit(wb_rec)
    check(wb_rec["ok"], f"whole-body loop check failed: {wb_rec}")

    # -------------- 7b. the whole-body loop, uncondensed NMPC -------------- #
    # bench_wholebody.py's default batch configuration: the NMPC uncondensed
    # (K1b at (41, 28), its first solve and one SCP round a domain), the
    # full LL QP (K1b at (43, 30)), cut in depth to 100 stand-up ticks and
    # the first 60 ticks of a domain
    unc_loop = wb_loop._replace(stand_ticks=100, ticks_per_domain=60)
    unc_ticks = unc_loop.stand_ticks + unc_loop.ticks_per_domain
    unc_mpc = MpcConfig(use_sqp=True, sqp_iters=1, condensed=False,
                        elide_box_rows=False, elide_simplex=False)
    run_wb(f32, WB_BATCH, closedloop.LoopConfig(2, 1, 2), unc_mpc)
    torch.cuda.synchronize()
    qp_shapes = {}
    real_qp_solve = qp_batch.solve

    def shape_counting(*a, **kw):
        key = f"{a[1].shape[1]}_{a[2].shape[1]}"
        qp_shapes[key] = qp_shapes.get(key, 0) + 1
        return real_qp_solve(*a, **kw)

    for k in all_counts:
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(qp_batch, "solve", shape_counting):
        res = run_wb(f32, WB_BATCH, unc_loop, unc_mpc)
    torch.cuda.synchronize()
    unc_wall = time.perf_counter() - t0
    unc_launches = dict(zip(("K1a", "K1b", "K2a", "K2b"),
                            (k.launches for k in all_counts)))
    unc_expect = {"K1a": 0, "K1b": unc_ticks + 2 * unc_loop.n_domains,
                  "K2a": 2 * unc_ticks, "K2b": 2 * unc_ticks}
    shape_expect = {"43_30": unc_ticks, "41_28": 2 * unc_loop.n_domains}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.sim.q, res.sim.qd, res.com_hist, res.qp_ok, res.mpc_ok,
        res.tau_hist))
    final_z = res.com_hist[:, -1, -1, 2]
    unc_rec = {
        "phase": "wholebody_uncondensed", "lanes": WB_BATCH,
        "dtype": "float32", "mpc": "uncondensed (bench_wholebody default)",
        "ticks_per_lane": unc_ticks, "stand_ticks": unc_loop.stand_ticks,
        "n_domains": unc_loop.n_domains,
        "ticks_per_domain": unc_loop.ticks_per_domain,
        "cut": ("100 stand ticks and the first 60 ticks of 1 domain "
                "against the script's 800 and 6 domains"),
        "wall_s": unc_wall,
        "ll_ticks_per_s": WB_BATCH * unc_ticks / unc_wall,
        "ll_qp_ok": res.qp_ok.double().mean().item(),
        "mpc_ok": res.mpc_ok.double().mean().item(),
        "final_com_z_min": final_z.min().item(),
        "final_com_z_max": final_z.max().item(),
        "launches": unc_launches, "expected_launches": unc_expect,
        "k1b_launches_by_shape": qp_shapes,
        "expected_k1b_by_shape": shape_expect, "finite": finite,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": smi,
        "bound": ("finite; final COM z > 0.2 m in every lane; exact launch "
                  "counts: K1b (43, 30) 1 a tick, (41, 28) 2 a domain, K2a "
                  "and K2b 2 a tick, no K1a")}
    unc_rec["ok"] = (finite and final_z.min().item() > 0.2
                     and unc_launches == unc_expect
                     and qp_shapes == shape_expect)
    emit(unc_rec)
    check(unc_rec["ok"], f"uncondensed whole-body loop check failed: "
          f"{unc_rec}")
    del res

    # --------------------------- 8. whole-body times ------------------------ #
    # K1b by CUDA events around back-to-back calls (a launch lasts
    # milliseconds: the host's share is small), in turns with its plain
    # version. A K2 launch lasts microseconds, less than its wrapper's host
    # work, so each K2 shape reports its device time (a CUDA graph of 100
    # launches, replayed: graph_ms) as `ms` and the host-inclusive time per
    # call (events around back-to-back calls) as `host_ms`; the library
    # call's device time comes from torch.profiler (a call that synchronises
    # cannot be captured in a graph) and its host-inclusive time as the
    # kernel's.
    data32, d32, dinv12_32, rhs32 = wb_qps[f32]["trot"]
    sk = qp_fused.solve(*data32, wb_relaxed)

    def k1b_kern():
        return qp_fused.solve(*data32, wb_relaxed)

    def k1b_plain():
        return qp_fused.solve_plain(*data32, wb_relaxed)

    k1b_plain()
    p1 = event_ms(k1b_plain, 3)
    t1 = event_ms(k1b_kern, REPS)
    t2 = event_ms(k1b_kern, REPS)
    p2 = event_ms(k1b_plain, 3)
    k1b_ms = ((t1 + t2) / 2, (p1 + p2) / 2)
    emit({"phase": "wb_times", "kernel": "K1b", "lanes": WB_BATCH,
          "dtype": "float32", "kernel_ms": [t1, t2], "plain_ms": [p1, p2],
          "library_ms": None, "device": smi})
    k2_ms = {}
    for kname, k, r, kern, plain, library in (
            ("K2a", 18, 1, functools.partial(spd.solve, d32, rhs32),
             functools.partial(spd.solve_plain, d32, rhs32),
             functools.partial(torch.linalg.solve, d32, rhs32)),
            ("K2b", 18, 0, functools.partial(spd.inverse, d32),
             functools.partial(spd.inverse_plain, d32),
             functools.partial(torch.linalg.inv, d32)),
            ("K2b_k12", 12, 0, functools.partial(spd.inverse, dinv12_32),
             functools.partial(spd.inverse_plain, dinv12_32),
             functools.partial(torch.linalg.inv, dinv12_32))):
        kern(), plain(), library()
        p1 = event_ms(plain, 3)
        dev_ms = graph_ms(kern)
        h1 = event_ms(kern, REPS)
        h2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        lib_ms = profiler_ms(library)
        lib_host = event_ms(library, REPS)
        k2_ms[kname] = dict(
            k=k, r=r or k, ms=sum(dev_ms) / len(dev_ms), host_ms=(h1 + h2) / 2,
            plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
            library_host_ms=lib_host,
            **bound(*k2_work(k, r or k, WB_BATCH, identity=r == 0)))
        emit({"phase": "wb_times", "kernel": kname, "k": k, "r": r or k,
              "lanes": WB_BATCH, "dtype": "float32", "device_ms": dev_ms,
              "host_ms": [h1, h2], "plain_ms": [p1, p2],
              "library_ms": lib_ms, "library_host_ms": lib_host,
              "geometry": spd.launch_geometry(f32, k, r, WB_BATCH),
              **bound(*k2_work(k, r or k, WB_BATCH, identity=r == 0)),
              "device": smi})

    k1b_full = dict(n=43, me=30, mi=45, lanes=WB_BATCH, ms=k1b_ms[0],
                    plain_ms=k1b_ms[1],
                    **bound(*k1b_work(data32, sk,
                                      wb_relaxed.kkt_refine_iters)))
    kernels.append(dict(
        name="qp_general", route="cuda", source="srbx_torch/csrc/qp_general.cu",
        replaces="srbx/ops/qp_fused.py:94", launches=wb_launches["K1b"],
        max_abs_err=k1b_f64_dx, library_ms=None,
        **{k: v for k, v in k1b_full.items()
           if k not in ("n", "me", "mi", "lanes")},
        launches_by_path={"wholebody": wb_launches["K1b"]},
        by_case={"full_43_30": k1b_full}))
    for name, replaces, key, err, cases in (
            ("spd_solve", "srbx/ops/spd.py:70", "K2a",
             k2_f64_rel["K2a spd.solve k18"], ("K2a",)),
            ("spd_inverse", "srbx/ops/spd.py:78", "K2b",
             max(k2_f64_rel["K2b spd.inverse k18"],
                 k2_f64_rel["K2b spd.inverse k12"]), ("K2b", "K2b_k12"))):
        main_case = {f: v for f, v in k2_ms[cases[0]].items()
                     if f not in ("k", "r")}
        kernels.append(dict(
            name=name, route="cuda", source="srbx_torch/csrc/spd.cu",
            replaces=replaces, launches=wb_launches[key], max_abs_err=err,
            **main_case, launches_by_path={"wholebody": wb_launches[key]},
            by_case={c: k2_ms[c] for c in cases}))
    kernels[0]["launches_by_path"]["wholebody"] = wb_launches["K1a"]

    # ----------------------- 9a. K2 kernels vs plain ----------------------- #
    # K2a and K2b bitwise against their plain versions on a ragged batch
    # (B - 3 lanes: the last block part full) of the loop's matrices and of
    # random SPD matrices at the edge shapes k 1, 12, 17, 18, 31, 32 with
    # r 1, 3, k, 32, each with one indefinite lane and again with NaN above
    # D's diagonal, in float64 and float32 (k2_checks)
    k2_counts = (spd.solve, spd.inverse)
    counts0 = [k.launches for k in k2_counts]
    t0 = time.perf_counter()
    k2_recs, k2_calls = k2_checks(spd, dev, WB_BATCH - 3)
    for rec in k2_recs:
        emit(rec)
        check(rec["ok"], f"K2 kernels disagree with their plain versions: "
              f"{rec}")
    check([k.launches - c for k, c in zip(k2_counts, counts0)]
          == [k2_calls["K2a"], k2_calls["K2b"]],
          "the K2 kernels' counters did not advance once per call")
    emit({"phase": "k2", "seconds": time.perf_counter() - t0,
          "cases": len(k2_recs), "launches": k2_calls})

    # ----------------------- 9b. K3 kernels vs plain ----------------------- #
    gen = torch.Generator(device=dev).manual_seed(11)
    bad_lane = 7

    def spd_batch(k, r, dtype, n_lanes=BATCH):
        """Well-conditioned SPD matrices (n_lanes, k, k) made on the card
        from a seed, lane `bad_lane` indefinite (a diagonal entry -1), and
        right-hand sides (n_lanes, k, r)."""
        a = torch.randn(n_lanes, k, k, generator=gen, device=dev,
                        dtype=dtype)
        m = a @ a.mT / k + torch.eye(k, dtype=dtype, device=dev)
        m[bad_lane, k // 2, k // 2] = -1.0
        rhs = torch.randn(n_lanes, k, r, generator=gen, device=dev,
                          dtype=dtype)
        return m, rhs

    def compare(rec, name, got, want, good, dtype):
        err = (got[good] - want[good]).abs().max().item()
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_max_rel_err"] = err / want[good].abs().max().item()
        rec[f"{name}_bitwise_equal"] = bool(torch.equal(got[good],
                                                        want[good]))
        rec[f"{name}_bad_lane_nonfinite"] = not bool(
            torch.isfinite(got[bad_lane]).all())
        rec[f"{name}_other_lanes_finite"] = bool(
            torch.isfinite(got[good]).all())
        if dtype == torch.float64:
            k3_f64_err[name] = max(k3_f64_err[name], err)

    def k3_cases(n_lanes, k, rs, dtype):
        """K3a on n_lanes k x k matrices, then K3b against its factor for
        each r in rs: one record per (k, r)."""
        bound_rel = 1e-12 if dtype == torch.float64 else 1e-5
        m, _ = spd_batch(k, 1, dtype, n_lanes)
        good = torch.ones(n_lanes, dtype=torch.bool, device=dev)
        good[bad_lane] = False
        # the kernels read only the lower triangles: NaN above the
        # diagonal of M and of L changes nothing
        upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
        lp = plin.batch_cholesky_plain(m)
        lk = plin.batch_cholesky(m)
        lk_nan = plin.batch_cholesky(m.masked_fill(upper, float("nan")))
        torch.cuda.synchronize()
        n_k3[0] += 2
        base = {"phase": "k3", "dtype": str(dtype), "lanes": n_lanes, "k": k,
                "bad_lane": bad_lane}
        compare(base, "K3a", lk, lp, good, dtype)
        base["K3a_upper_zero"] = bool((lk.triu(1) == 0).all())
        lower_only = torch.equal(lk_nan[good], lk[good])
        del lk, lk_nan, m
        lp_nan = lp.masked_fill(upper, float("nan"))
        for r in rs:
            rhs = torch.randn(n_lanes, k, r, generator=gen, device=dev,
                              dtype=dtype)
            xk = plin.batch_cho_solve(lp, rhs)
            xp = plin.batch_cho_solve_plain(lp, rhs)
            xk_nan = plin.batch_cho_solve(lp_nan, rhs)
            torch.cuda.synchronize()
            n_k3[1] += 2
            rec = dict(base, r=r)
            compare(rec, "K3b", xk, xp, good, dtype)
            rec["upper_triangle_ignored"] = (
                lower_only and torch.equal(xk_nan[good], xk[good]))
            rec["bound"] = (f"bitwise equal on the other lanes (and max|d| "
                            f"/ max|value| <= {bound_rel:g}); the indefinite "
                            "lane non-finite, every other lane finite; "
                            "strict upper triangle of L exactly zero; NaN "
                            "above the diagonal of M and L changes no other "
                            "lane")
            rec["ok"] = (all((rec[f"{n}_max_rel_err"] <= bound_rel
                              and rec[f"{n}_bitwise_equal"]
                              and rec[f"{n}_bad_lane_nonfinite"]
                              and rec[f"{n}_other_lanes_finite"])
                             for n in ("K3a", "K3b"))
                         and rec["K3a_upper_zero"]
                         and rec["upper_triangle_ignored"])
            emit(rec)
            check(rec["ok"], f"K3 kernels disagree with their plain "
                  f"versions: {rec}")
            del rhs, xk, xp, xk_nan

    k3_counts = (plin.batch_cholesky, plin.batch_cho_solve)
    counts0 = [k.launches for k in k3_counts]
    k3_f64_err = {"K3a": 0.0, "K3b": 0.0}
    n_k3 = [0, 0]
    # the generic cycle's (k, r) on B lanes: M^-1 A' (41, 28), M and S
    # solves (41, 1) and (28, 1); the condensed forms' (17, 4) and (13, 1);
    # then on B - 3 lanes (a multiple of no block's lanes) the path's k and
    # the edge shapes k 1, 33, 64 with r 1, 3, 32, 64
    k3_grid = [(BATCH, 41, (28, 1)), (BATCH, 28, (1,)), (BATCH, 17, (4,)),
               (BATCH, 13, (1,)), (BATCH - 3, 41, (28, 1)),
               (BATCH - 3, 28, (1,))] + [
        (BATCH - 3, k, (1, 3, 32, 64)) for k in (1, 33, 64)]
    t0 = time.perf_counter()
    for dtype in (torch.float64, f32):
        for n_lanes, k, rs in k3_grid:
            k3_cases(n_lanes, k, rs, dtype)
    check([k.launches - c for k, c in zip(k3_counts, counts0)] == n_k3,
          "the K3 kernels' counters did not advance once per call")
    emit({"phase": "k3", "seconds": time.perf_counter() - t0,
          "launches": n_k3})

    # ------------------------ 10. the generic cycle ------------------------ #
    # The reference-shape formulation off the TPU: uncondensed (n 41, me 28,
    # mi 92; SCP mi 112), the step-fused batched IPM with backend "pallas".
    gen_cfg = MpcConfig(use_sqp=True, sqp_iters=2)

    def gen_cycle(args, qp_cfg):
        return mpc_batch.run_nmpc_batch(gen_cfg, qp_cfg, *args,
                                        backend="pallas", condensed=False)

    solve_iters = []
    real_solve = qp_batch.solve

    def recording_solve(*a, **kw):
        sol = real_solve(*a, **kw)
        solve_iters.append(int(sol.iters))
        return sol

    def expected_k3(qp_cfg):
        """K3 launches of the solves just recorded: per solve with I
        iterations, K3a 2 + 2 I and K3b 3 + (1 + 4 (1 + R)) I."""
        refine = qp_cfg.kkt_refine_iters
        return (sum(2 + 2 * i for i in solve_iters),
                sum(3 + (1 + 4 * (1 + refine)) * i for i in solve_iters))

    args = lanes(f32)
    gen_cycle(args, relaxed)                   # warm-up
    torch.cuda.synchronize()
    gen_runs = {}
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        solve_iters.clear()
        for k in k3_counts + (qp_fused.solve_lanes_last, qp_fused.solve):
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(qp_batch, "solve", recording_solve):
            out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K3a": plin.batch_cholesky.launches,
                    "K3b": plin.batch_cho_solve.launches,
                    "K1a": qp_fused.solve_lanes_last.launches,
                    "K1b": qp_fused.solve.launches}
        exp_a, exp_b = expected_k3(qp_cfg)
        expect = {"K3a": exp_a, "K3b": exp_b, "K1a": 0, "K1b": 0}
        finite = all(bool(torch.isfinite(getattr(out, n)).all()) for n in (
            "alpha_com", "states", "inputs", "x", "cbf_margin"))
        rec = {"phase": "generic_cycle", "config": cfg_name, "lanes": BATCH,
               "dtype": "float32", "n": 41, "me": 28,
               "mi": [92, 112, 112], "solve_iters": list(solve_iters),
               "launches": launches, "expected_launches": expect,
               "converged": out.qp_converged.double().mean().item(),
               "qp_iters": int(out.qp_iters), "wall_s": wall,
               "finite": finite,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "shapes_ok": tuple(out.states.shape) == (BATCH, 4, 4),
               "bound": ("finite; exact K3 launch counts, no K1 launch; "
                         "first solve's converged share >= 0.9 relaxed"),
               "device": smi}
        rec["ok"] = (finite and launches == expect and rec["shapes_ok"]
                     and (cfg_name == "strict" or rec["converged"] >= 0.9))
        gen_runs[cfg_name] = rec
        emit(rec)
        check(rec["ok"], f"generic cycle check failed: {rec}")

    # the first lanes in float64, through the kernels and through the plain
    # versions: the K3 kernels are bitwise their plain versions, so rounding
    # elsewhere is the only difference, and there is none
    args64 = lanes(torch.float64, CROSS_LANES)
    with mock.patch.object(plin, "batch_cholesky",
                           plin.batch_cholesky_plain), \
            mock.patch.object(plin, "batch_cho_solve",
                              plin.batch_cho_solve_plain):
        ref64 = gen_cycle(args64, strict)
    ker64 = gen_cycle(args64, strict)
    torch.cuda.synchronize()
    cross = {"phase": "generic_cycle", "what": "f64 kernels vs plain",
             "lanes": CROSS_LANES, "config": "strict",
             "states": maxdiff(ker64.states, ref64.states),
             "alpha_com": maxdiff(ker64.alpha_com, ref64.alpha_com),
             "converged_equal": bool(
                 (ker64.qp_converged == ref64.qp_converged).all()),
             "converged": ker64.qp_converged.double().mean().item(),
             "bound": "states and alpha_com <= 1e-9; equal converged flags"}
    cross["ok"] = (cross["states"] <= 1e-9 and cross["alpha_com"] <= 1e-9
                   and cross["converged_equal"])
    emit(cross)
    check(cross["ok"], f"generic cycle cross-check failed: {cross}")

    # ----------------------- 11. generic-cycle times ---------------------- #
    pallas_times = {}
    for cfg_name, qp_cfg in (("relaxed", relaxed), ("strict", strict)):
        out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN_REPS):
            out = gen_cycle(args, qp_cfg)
        torch.cuda.synchronize()
        pipelined = BATCH * GEN_REPS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(GEN_REPS):
            out = gen_cycle(args, qp_cfg)
            torch.cuda.synchronize()
        synced = BATCH * GEN_REPS / (time.perf_counter() - t0)
        pallas_times[cfg_name] = {"pipelined": pipelined, "synced": synced}
        emit({"phase": "times", "what": "generic_cycle", "config": cfg_name,
              "lanes": BATCH, "dtype": "float32", "reps": GEN_REPS,
              "cycles_per_s_pipelined": pipelined,
              "cycles_per_s_synced": synced,
              "converged": out.qp_converged.double().mean().item(),
              "qp_iters": int(out.qp_iters), "device": smi})

    # K3 at each (k, r) the relaxed generic cycle launched it with: the
    # factorizations of M (k 41) and S (k 28) once per solve start and per
    # iteration, M^-1 A' (41, 28) as often, and 2 (1 + R) single solves per
    # iteration against M (41, 1) and S (28, 1); each kernels-line row
    # weights its shapes by those launches
    iters = gen_runs["relaxed"]["solve_iters"]
    n_solves, n_iters = len(iters), sum(iters)
    singles = n_solves + 2 * (1 + relaxed.kkt_refine_iters) * n_iters
    k3_shapes = {("K3a", 41, 0): n_solves + n_iters,
                 ("K3a", 28, 0): n_solves + n_iters,
                 ("K3b", 41, 28): n_solves + n_iters,
                 ("K3b", 41, 1): singles, ("K3b", 28, 1): singles}
    for name in ("K3a", "K3b"):
        check(sum(n for (kn, _, _), n in k3_shapes.items() if kn == name)
              == gen_runs["relaxed"]["launches"][name],
              f"{name}'s launches per shape do not add up to its count")
    k3_ms = {}
    for (name, k, r), n_launch in k3_shapes.items():
        m, rhs = spd_batch(k, max(r, 1), f32)
        m[bad_lane] = torch.eye(k, dtype=f32, device=dev)
        l = plin.batch_cholesky_plain(m)
        if name == "K3a":
            kern = functools.partial(plin.batch_cholesky, m)
            plain = functools.partial(plin.batch_cholesky_plain, m)
            library = functools.partial(torch.linalg.cholesky_ex, m)
        else:
            kern = functools.partial(plin.batch_cho_solve, l, rhs)
            plain = functools.partial(plin.batch_cho_solve_plain, l, rhs)
            library = functools.partial(torch.cholesky_solve, rhs, l)
        kern(), plain(), library()
        p1 = event_ms(plain, 3)
        t1 = event_ms(kern, REPS)
        t2 = event_ms(kern, REPS)
        p2 = event_ms(plain, 3)
        lib_ms = event_ms(library, REPS)
        k3_ms[name, k, r] = {"ms": (t1 + t2) / 2, "plain_ms": (p1 + p2) / 2,
                             "library_ms": lib_ms,
                             **bound(*k3_work(k, r, BATCH))}
        emit({"phase": "times", "what": name, "k": k, "r": r or None,
              "lanes": BATCH, "dtype": "float32", "kernel_ms": [t1, t2],
              "plain_ms": [p1, p2], "library_ms": lib_ms,
              "launches_relaxed_cycle": n_launch,
              **bound(*k3_work(k, r, BATCH)), "device": smi})
    for name, key, replaces, err in (
            ("pallas_cholesky", "K3a", "srbx/ops/pallas_linalg.py:27",
             k3_f64_err["K3a"]),
            ("pallas_cho_solve", "K3b", "srbx/ops/pallas_linalg.py:62",
             k3_f64_err["K3b"])):
        launches = gen_runs["relaxed"]["launches"][key]
        shapes = {s: n for s, n in k3_shapes.items() if s[0] == key}
        mean = {f: sum(n * k3_ms[s][f] for s, n in shapes.items()) / launches
                for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "bytes", "flops")}
        bytes_bound = all(k3_ms[s]["bound_by"] == "bytes" for s in shapes)
        kernels.append(dict(
            name=name, route="cuda", source="srbx_torch/csrc/pallas_linalg.cu",
            replaces=replaces, launches=launches, max_abs_err=err, **mean,
            bound_by="bytes" if bytes_bound else "operations",
            weighted_over={f"k{k}" + (f"_r{r}" if r else ""): n
                           for (_, k, r), n in shapes.items()},
            launches_by_path={"generic_cycle": launches}))
    # -------------- 14. the NMPC on "fused" at its own shapes -------------- #
    # (run before the campaign and the team, beside phase 11's cycle)
    new_rows = nmpc_fused_phase(dev, smi, inputs, p_start, relaxed, strict,
                                pallas_times)
    # ------------------------- 12. the campaign -------------------------- #
    camp = campaign_phase(dev, smi)
    k1a_row = kernels[0]
    k1a_row["launches_by_path"].update(camp["K1a"])
    k1a_row["by_case"].update(camp["k1a_cases"])
    k1a_row["max_abs_err"] = max(k1a_row["max_abs_err"], camp["k1a_f64_err"])
    for row in kernels:
        key = {"pallas_cholesky": "K3a", "pallas_cho_solve": "K3b"}.get(
            row["name"])
        if key:
            row["launches_by_path"]["template_campaign_golden"] = \
                camp["K3"][key]
    # ------------------------- 13. the team ------------------------------ #
    team = team_phase(dev, smi)
    # the team golden and the float64 runs of phases 7 and 15-19 go on in
    # side processes beside phases 15 and 16, which time host-bound loops
    # only; phase 17 waits for every one of them
    est_w = types.SimpleNamespace(
        model=model, ll_cfg=ll_cfg, motion_cfg=motion_cfg, sim_cfg=sim_cfg,
        mpc=wb_mpc, relaxed=wb_relaxed, pr=wb_pr, prd=wb_prd, a0=wb_a0,
        pobs=wb_pobs, dev=dev, golden=team_golden_plan(dev),
        lanes=loop_lanes(dev, wb_pr, wb_prd, wb_a0, wb_pobs))
    sides = []
    try:
        sides.extend(start_side(est_w, jobs) for jobs in SIDE_GROUPS)
        side = side_results(list(sides), smi)
        sides.append(start_side(est_w, AGENT_GROUP))
        agent_side = side_results(sides[-1:], smi)
        # ----------------- 15. est_loop and 16. event ------------------- #
        est = estimation_phases(dev, smi, est_w, side)
        team["team_golden"] = team_golden_check(
            side("golden"), est_w.golden["planner_s"], smi)
        wholebody_cross(side("wb"), smi)
        agent_run, agent_team = (agent_side(job) for job in AGENT_GROUP)
        # ----------------------- 17. disturbance ------------------------ #
        clf = {**side("clf32"), **side("clf"),
               "seconds": [side("clf32")["seconds"], side("clf")["seconds"]]}
        est["disturbance"] = disturbance_phase(dev, smi, est_w, side("dist"),
                                               clf)
        # ---------------------- 18. velocity_gait ----------------------- #
        est["velocity_gait"] = velocity_phase(dev, smi, est_w, side("vel"),
                                              side("vel_plain"))
        # ------------------------- 19. per_agent ------------------------ #
        est["per_agent"] = per_agent_phase(dev, smi, est_w, agent_run,
                                           agent_team)
    finally:
        for proc, *_ in sides:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    kernel_keys = {"qp_fused_noeq": ("K1a",), "qp_general": ("K1b",),
                   "spd_solve": ("K2a",), "spd_inverse": ("K2b",),
                   "pallas_cholesky": ("K3a",), "pallas_cho_solve": ("K3b",)}
    for row in kernels:
        (key,) = kernel_keys[row["name"]]
        for path in ("team", "team_golden"):
            row["launches_by_path"][path] = team[path][key]
        for path in ("est_loop", "event", "disturbance", "velocity_gait",
                     "per_agent"):
            row["launches_by_path"][path] = est[path][key]
        if key == "K1b":
            row["by_case"].update(team["k1b_cases"])
            row["max_abs_err"] = max(row["max_abs_err"], team["k1b_f64_dx"])
    for row in kernels:
        if row["name"] == "qp_general":
            row["launches_by_path"]["wholebody_uncondensed"] = \
                unc_launches["K1b"]
    for row in new_rows:
        if row["name"] == "qp_general_41_28":
            row["launches_by_path"]["wholebody_uncondensed"] = \
                qp_shapes["41_28"]
        # the per-agent path runs no kernel: its counts are K1's at any shape
        row["launches_by_path"]["per_agent"] = est["per_agent"][
            "K1b" if row["name"].startswith("qp_general") else "K1a"]
    kernels += new_rows
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
