"""Unitree A1 model parameters (static data, the same as the JAX package's
`srbx/models/a1.py`).

Physical constants extracted from the reference's robot description
`rsc/A1/A1_modified.urdf` (data, not code): joint origins/axes, link masses,
COM offsets, and inertia tensors. The foot (0.06 kg, tiny isotropic inertia)
is attached to the calf as a point mass at the toe.

Joint order matches the reference's generalized coordinates
(`src/A1_Sim.cpp:129-154`): base pos, base XYZ-Euler, then
FR/FL/RR/RL x (hip, thigh, calf). Total mass is 12.453 kg — identical to
the SRB template mass (`src/forceUpdate.cpp:5`).
"""

from __future__ import annotations

import functools

from srbx_torch.models.rbd import Link, Model

_LEGS = ("FR", "FL", "RR", "RL")
_HIP_XY = {  # trunk -> hip-joint origin
    "FR": (0.183, -0.047, 0.0),
    "FL": (0.183, 0.047, 0.0),
    "RR": (-0.183, -0.047, 0.0),
    "RL": (-0.183, 0.047, 0.0),
}
_THIGH_Y = {"FR": -0.08505, "FL": 0.08505, "RR": -0.08505, "RL": 0.08505}

_HIP_COM = {
    "FR": (-0.003311, -0.000635, 3.1e-05),
    "FL": (-0.003311, 0.000635, 3.1e-05),
    "RR": (0.003311, -0.000635, 3.1e-05),
    "RL": (0.003311, 0.000635, 3.1e-05),
}
_HIP_I = {
    "FR": (0.000469246, 9.409e-06, -3.42e-07, 0.00080749, 4.66e-07, 0.000552929),
    "FL": (0.000469246, -9.409e-06, -3.42e-07, 0.00080749, -4.66e-07, 0.000552929),
    "RR": (0.000469246, -9.409e-06, 3.42e-07, 0.00080749, 4.66e-07, 0.000552929),
    "RL": (0.000469246, 9.409e-06, 3.42e-07, 0.00080749, -4.66e-07, 0.000552929),
}
_THIGH_COM = {
    "FR": (-0.003237, 0.022327, -0.027326),
    "FL": (-0.003237, -0.022327, -0.027326),
    "RR": (-0.003237, 0.022327, -0.027326),
    "RL": (-0.003237, -0.022327, -0.027326),
}
_THIGH_I = {
    "FR": (0.005529065, -4.825e-06, 0.000343869, 0.005139339, -2.2448e-05, 0.001367788),
    "FL": (0.005529065, 4.825e-06, 0.000343869, 0.005139339, 2.2448e-05, 0.001367788),
    "RR": (0.005529065, -4.825e-06, 0.000343869, 0.005139339, -2.2448e-05, 0.001367788),
    "RL": (0.005529065, 4.825e-06, 0.000343869, 0.005139339, 2.2448e-05, 0.001367788),
}
_CALF_COM = (0.006435, 0.0, -0.107388)
_CALF_I = (0.002997972, 0.0, -0.000141163, 0.003014022, 0.0, 3.2426e-05)

_TRUNK_MASS = 4.713
_TRUNK_COM = (0.012731, 0.002186, 0.000515)
_TRUNK_I = (0.01683993, 8.3902e-05, 0.000597679, 0.056579028, 2.5134e-05, 0.064713601)

THIGH_LEN = 0.2
CALF_LEN = 0.2
FOOT_MASS = 0.06


@functools.lru_cache(maxsize=None)
def model() -> Model:
    links = []
    sites = []
    for li, leg in enumerate(_LEGS):
        hip_idx = 3 * li
        links.append(
            Link(
                name=f"{leg}_hip", parent=-1,
                joint_origin=_HIP_XY[leg], joint_axis=(1.0, 0.0, 0.0),
                mass=0.696, com=_HIP_COM[leg], inertia=_HIP_I[leg],
            )
        )
        links.append(
            Link(
                name=f"{leg}_thigh", parent=hip_idx,
                joint_origin=(0.0, _THIGH_Y[leg], 0.0), joint_axis=(0.0, 1.0, 0.0),
                mass=1.013, com=_THIGH_COM[leg], inertia=_THIGH_I[leg],
            )
        )
        links.append(
            Link(
                name=f"{leg}_calf", parent=hip_idx + 1,
                joint_origin=(0.0, 0.0, -THIGH_LEN), joint_axis=(0.0, 1.0, 0.0),
                mass=0.166, com=_CALF_COM, inertia=_CALF_I,
                point_masses=((FOOT_MASS, (0.0, 0.0, -CALF_LEN)),),
            )
        )
        sites.append((f"{leg}_toe", hip_idx + 2, (0.0, 0.0, -CALF_LEN)))
    for li, leg in enumerate(_LEGS):
        # "hip" FK site = thigh-joint (shoulder) origin, the frame used for
        # Raibert foothold targets (initialFootprint y = 0.047 + 0.08505).
        sites.append((f"{leg}_hip", 3 * li, (0.0, _THIGH_Y[leg], 0.0)))

    return Model(
        base_mass=_TRUNK_MASS,
        base_com=_TRUNK_COM,
        base_inertia=_TRUNK_I,
        links=tuple(links),
        sites=tuple(sites),
    )


TOE_SITES = slice(0, 4)   # site rows 0..3 = FR, FL, RR, RL toes
HIP_SITES = slice(4, 8)   # site rows 4..7 = hips
