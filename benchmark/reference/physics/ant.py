"""The low-gear quadruped ant.

Semantics of the reference MJCF
(`ddiffpg/env/d4rl/locomotion/assets/low_gear_ant.xml`):
torso sphere r=0.25 with four welded 'aux' capsules; per leg a hip hinge
(axis z, range +-30 deg) and an ankle hinge (diagonal axis, |range| 30-70
deg); geom density 5, friction 1; joint armature 1, damping 1; 8 motors,
gear 30, ctrl in [-1, 1]; init qpos ankle angles +-1 rad, torso z 0.55.
Bodies without joints (the leg roots holding the aux geoms) are merged into
the torso, as MuJoCo's compiler effectively welds them.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.physics import types as T
from benchmark.reference.physics.builder import BodySpec, GeomSpec, JointSpec, build

DEG = np.pi / 180.0
DENSITY = 5.0
R_LEG = 0.08

# per-leg sign pattern (x, y) for legs 1..4 (front-left, front-right, back,
# right-back) and the ankle hinge axes / ranges from the MJCF
LEG_DIR = [(1, 1), (-1, 1), (-1, -1), (1, -1)]
ANKLE_AXIS = [(-1, 1, 0), (1, 1, 0), (-1, 1, 0), (1, 1, 0)]
ANKLE_RANGE = [(30, 70), (-70, -30), (-70, -30), (30, 70)]
INIT_ANKLE = [1.0, -1.0, -1.0, 1.0]
# actuator order in the MJCF: hip_4, ankle_4, hip_1, ankle_1, hip_2, ...
ACTUATOR_ORDER = [4, 1, 2, 3]

GEAR = 30.0
HIP_RANGE = (-30 * DEG, 30 * DEG)


def build_ant(static_boxes=None, dt=0.005, n_substeps=20, **kw) -> T.Model:
    torso_geoms = [GeomSpec(T.SPHERE, (0.25,), density=DENSITY)]
    for sx, sy in LEG_DIR:
        torso_geoms.append(GeomSpec.capsule_fromto(
            R_LEG, (0, 0, 0), (0.2 * sx, 0.2 * sy, 0), density=DENSITY))

    bodies = [BodySpec("torso", "", pos=(0, 0, 0.75),
                       joint=JointSpec(T.FREE), geoms=torso_geoms)]
    actuators = []
    for leg in range(4):
        sx, sy = LEG_DIR[leg]
        hip = BodySpec(
            f"hip_{leg + 1}", "torso", pos=(0.2 * sx, 0.2 * sy, 0),
            joint=JointSpec(T.HINGE, axis=(0, 0, 1), armature=1.0, damping=1.0,
                            limit=HIP_RANGE),
            geoms=[GeomSpec.capsule_fromto(
                R_LEG, (0, 0, 0), (0.2 * sx, 0.2 * sy, 0), density=DENSITY)])
        lo, hi = ANKLE_RANGE[leg]
        ankle = BodySpec(
            f"ankle_{leg + 1}", f"hip_{leg + 1}", pos=(0.2 * sx, 0.2 * sy, 0),
            joint=JointSpec(T.HINGE, axis=ANKLE_AXIS[leg], armature=1.0,
                            damping=1.0, limit=(lo * DEG, hi * DEG)),
            geoms=[GeomSpec.capsule_fromto(
                R_LEG, (0, 0, 0), (0.4 * sx, 0.4 * sy, 0), density=DENSITY)])
        bodies.extend([hip, ankle])

    for leg in ACTUATOR_ORDER:
        actuators.append((f"hip_{leg}", GEAR))
        actuators.append((f"ankle_{leg}", GEAR))

    init_qpos = np.zeros(15, np.float32)
    init_qpos[2] = 0.55
    init_qpos[3] = 1.0
    for leg in range(4):
        init_qpos[7 + 2 * leg] = 0.0                 # hip
        init_qpos[7 + 2 * leg + 1] = INIT_ANKLE[leg]  # ankle

    return build(bodies, actuators, static_boxes=static_boxes,
                 init_qpos=init_qpos, dt=dt, n_substeps=n_substeps, **kw)
