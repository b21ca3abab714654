"""srbx_torch: the PyTorch / CUDA port of srbx's batched CBF-NMPC cycle.

The JAX package `srbx` stays as the reference; this package mirrors its
module names and shares its configuration dataclasses (`srbx.config`, which
imports no jax, re-exported as `srbx_torch.config`). It imports `torch` and
never `jax`.

  srbx_torch.config       the configuration dataclasses (from srbx.config)
  srbx_torch.models.lip   LIP discretization constants
  srbx_torch.refplan      APF multi-agent reference planner
  srbx_torch.ocp          lane-batched QP assembly and condensed expansion
  srbx_torch.sqp          velocity and linearised CBF rows
  srbx_torch.mpc          carry / output types, per-lane helpers
  srbx_torch.mpc_batch    run_nmpc_batch: the lanes-last fused cycle
  srbx_torch.ops          fused IPM (CUDA kernel + plain version), Bezier
  srbx_torch.convert      state conversion to and from numpy / the JAX types

Every function takes tensors with a leading lane axis and an explicit dtype
and device; there is no global default device.
"""
