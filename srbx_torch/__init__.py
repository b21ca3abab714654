"""srbx_torch: the PyTorch / CUDA port of srbx's batched CBF-NMPC cycle,
whole-body closed loops (one robot a lane, and teams) and campaigns.

The JAX package `srbx` stays as the reference; this package mirrors its
module names and keeps its own copy of the configuration dataclasses. It
imports `torch`, never `jax`, and nothing of `srbx`.

  srbx_torch.config          the configuration dataclasses
  srbx_torch.models          LIP constants, rigid-body dynamics, the A1 model
  srbx_torch.refplan         APF multi-agent reference planner
  srbx_torch.ocp, .sqp       lane-batched NMPC QP assembly and SCP rows
  srbx_torch.mpc, .mpc_batch run_nmpc_batch: the lanes-last fused cycle and
                             the generic (condensed or full-QP) cycle
  srbx_torch.motion, .agent  gait planning and the 1 kHz control tick
  srbx_torch.lowlevel        virtual constraints and the LL QP
  srbx_torch.estimation      the contact debouncer and estimators; the
                             KF, kinematic odometry and the pipeline that
                             closes them into the loops
  srbx_torch.sim             batched physics (with stick-slip contact and
                             trunk forces), the sensor model and the
                             closed loops (run_batch, also under pushes;
                             the team's run_team_batch, the event-driven
                             run_batch_event), with or without estimation
  srbx_torch.utils           transforms; prng, the JAX package's random
                             streams (threefry2x32)
  srbx_torch.ops             CUDA kernels K1a, K1b, K2a, K2b, K3a, K3b with
                             their plain PyTorch versions; the batched IPM
                             (qp_batch) and Ruiz equilibration (qp);
                             Bezier curves
  srbx_torch.eval            the template A/B campaign and the team runner
  srbx_torch.convert         state conversion to and from numpy / JAX types

Every function takes tensors with a leading lane axis; entry points that
create tensors take a `device`, where None means the CUDA card.
"""
