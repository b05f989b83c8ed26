"""Model / State containers for the articulated dynamics engine (torch port).

A Model is a set of fixed-shape arrays describing the kinematic tree, geoms
and actuators — the compiled equivalent of the reference's MJCF XML + URDF
scene descriptions (low_gear_ant.xml, maze XML surgery at
ddiffpg/env/d4rl/locomotion/maze_env.py:269-288). Scenes are
typed Python specs, not XML.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

# joint types
FREE, HINGE, SLIDE, FIXED = 0, 1, 2, 3
# geom types
SPHERE, CAPSULE, BOX, PLANE = 0, 1, 2, 3


@dataclass(frozen=True)
class Model:
    """Static scene description. numpy fields are baked into the kernel build
    (sizes as compile-time defines, arrays as `__constant__` data).

    Bodies are topologically ordered (parent index < body index; parent of
    the root is -1). Each body has exactly one joint connecting it to its
    parent (FREE: 6 dof / 7 qpos, HINGE/SLIDE: 1 dof, FIXED: 0).
    """
    # tree
    parent: np.ndarray          # [nb] int
    jnt_type: np.ndarray        # [nb] int
    body_pos: np.ndarray        # [nb, 3] body frame origin in parent frame
    body_quat: np.ndarray       # [nb, 4] fixed rotation rel. to parent
    jnt_axis: np.ndarray        # [nb, 3] joint axis in body frame (hinge/slide)
    jnt_pos: np.ndarray         # [nb, 3] joint anchor in body frame
    # per-body mass properties (about body COM, in body frame)
    mass: np.ndarray            # [nb]
    com: np.ndarray             # [nb, 3] COM in body frame
    inertia: np.ndarray         # [nb, 3, 3] rotational inertia about COM
    # per-dof
    dof_body: np.ndarray        # [nv] body index of each dof
    dof_armature: np.ndarray    # [nv]
    dof_damping: np.ndarray     # [nv]
    # joint limits (hinge/slide only; +-inf if unlimited); indexed per dof
    dof_limit_lo: np.ndarray    # [nv]
    dof_limit_hi: np.ndarray    # [nv]
    # qpos layout
    jnt_qposadr: np.ndarray     # [nb] start index into qpos
    jnt_dofadr: np.ndarray      # [nb] start index into qvel
    nq: int
    nv: int
    nb: int
    # geoms
    geom_body: np.ndarray       # [ng] body index (-1 = world/static)
    geom_type: np.ndarray       # [ng] int
    geom_pos: np.ndarray        # [ng, 3] in body frame
    geom_quat: np.ndarray       # [ng, 4]
    geom_size: np.ndarray       # [ng, 3] sphere: (r,-,-) capsule: (r, halflen,-) box: half extents
    geom_friction: np.ndarray   # [ng] tangential friction coeff
    ng: int
    # static collision world: axis-aligned boxes + ground plane z=0
    static_box_min: np.ndarray  # [nsb, 3]
    static_box_max: np.ndarray  # [nsb, 3]
    nsb: int
    # actuators: type 0 = direct torque (tau += gear * clip(ctrl, -1, 1)),
    # type 1 = position servo (tau += clip(kp*(ctrl - q) - kd*qdot, +-force))
    # — the engine equivalent of PyBullet POSITION_CONTROL with joint_forces
    # (reference pybullet.py:368-383)
    act_dof: np.ndarray         # [nu] target dof index
    act_gear: np.ndarray        # [nu]
    act_type: np.ndarray        # [nu] int
    act_kp: np.ndarray          # [nu]
    act_kd: np.ndarray          # [nu]
    act_force: np.ndarray       # [nu] servo force limit
    nu: int
    # defaults
    init_qpos: np.ndarray       # [nq]
    init_qvel: np.ndarray       # [nv]
    # optional precomputed 2-D signed-distance field of the static world
    # (grid-aligned mazes): one bilinear lookup replaces per-probe tests
    # against every wall box. dist > 0 outside walls; valid below sdf_zmax.
    sdf_dist: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))  # [Nx, Ny]
    sdf_grad: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0, 2), np.float32))
    sdf_origin: Tuple[float, float] = (0.0, 0.0)
    sdf_cell: float = 0.125
    sdf_zmax: float = 2.0
    # integration / contact parameters
    dt: float = 0.005
    n_substeps: int = 20        # control dt = dt * n_substeps
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    # MuJoCo-solref-style soft contact (low_gear_ant.xml solref=".02 1"):
    # per-contact stiffness/damping scale with the touching body's mass,
    # k = m_eff * omega^2, c = 2 * zeta * m_eff * omega, omega = 1/timeconst
    # — keeps c*dt/m_eff uniform across light/heavy bodies so the
    # semi-implicit integrator stays stable for every geom.
    contact_timeconst: float = 0.02
    contact_dampratio: float = 1.0
    # Hunt-Crossley-style separation gate: the normal force is scaled by
    # clip(1 - v_n / maxrebound, 0, 1), so a separating contact (v_n > 0)
    # can never be pushed out faster than ~maxrebound. Rest (v_n = 0) and
    # approach (v_n < 0) are unchanged. This makes impacts strictly
    # dissipative under the discrete integrator: the bare damped spring
    # returns real energy on deep fast impacts, and policies learn to pump
    # it into metres-high ballistic hops (MuJoCo's constraint solver is
    # inelastic, so the reference ant cannot do this).
    contact_maxrebound: float = 0.5
    friction_vel_tol: float = 0.1   # viscous->Coulomb transition velocity
    limit_stiffness: float = 300.0
    limit_damping: float = 5.0
    # hard generalized-velocity clamp applied every substep. Two failure
    # modes motivate it: penalty-contact corners pumping energy until the
    # state overflows, and fast falls tunneling through the ground plane
    # (one substep of travel must stay below the smallest contact-sphere
    # radius: 20 m/s * dt 0.01 = 0.2 m < torso r 0.25). Legitimate ant
    # motion stays well under 20 m/s / 20 rad/s.
    max_qvel: float = 20.0


@dataclass
class State:
    qpos: torch.Tensor  # [..., nq]
    qvel: torch.Tensor  # [..., nv]
