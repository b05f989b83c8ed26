"""Model builder: typed body/geom specs -> Model arrays.

Computes mass properties from geom shapes and density (MuJoCo's
`inertiafromgeom`, cf. low_gear_ant.xml compiler flags), combining multiple
geoms per body about the body COM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.physics import types as T


@dataclass
class GeomSpec:
    type: int                      # T.SPHERE / T.CAPSULE / T.BOX
    size: Tuple[float, ...]        # sphere: (r,), capsule: (r, halflen), box: half extents
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    density: float = 1000.0
    friction: float = 1.0

    @staticmethod
    def capsule_fromto(r, a, b, density=1000.0, friction=1.0) -> "GeomSpec":
        a, b = np.asarray(a, float), np.asarray(b, float)
        center = (a + b) / 2
        d = b - a
        L = np.linalg.norm(d)
        quat = _quat_z_to(d / L) if L > 1e-12 else (1.0, 0.0, 0.0, 0.0)
        return GeomSpec(T.CAPSULE, (float(r), float(L / 2)), tuple(center),
                        tuple(quat), density, friction)


@dataclass
class JointSpec:
    type: int = T.FIXED
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    armature: float = 0.0
    damping: float = 0.0
    limit: Optional[Tuple[float, float]] = None     # radians / meters
    stiffness: float = 0.0


@dataclass
class BodySpec:
    name: str
    parent: str                     # '' for the root's parent (world)
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    joint: JointSpec = field(default_factory=JointSpec)
    geoms: List[GeomSpec] = field(default_factory=list)
    # explicit mass override (None -> from geoms+density)
    mass: Optional[float] = None
    inertia_diag: Optional[Tuple[float, float, float]] = None
    com: Optional[Tuple[float, float, float]] = None


def _quat_z_to(v):
    """Quaternion rotating +z onto unit vector v."""
    z = np.array([0.0, 0.0, 1.0])
    v = np.asarray(v, float)
    c = float(np.dot(z, v))
    if c > 1 - 1e-10:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-10:
        return np.array([0.0, 1.0, 0, 0])
    axis = np.cross(z, v)
    axis /= np.linalg.norm(axis)
    half = np.arccos(np.clip(c, -1, 1)) / 2
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


def _quat_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def geom_mass_inertia(g: GeomSpec):
    """(mass, COM in geom frame, inertia diag about COM in geom frame)."""
    if g.type == T.SPHERE:
        r = g.size[0]
        m = g.density * 4.0 / 3.0 * np.pi * r**3
        i = 2.0 / 5.0 * m * r**2
        return m, np.zeros(3), np.diag([i, i, i])
    if g.type == T.CAPSULE:
        r, h = g.size[0], g.size[1]
        mc = g.density * np.pi * r**2 * (2 * h)
        ms = g.density * 4.0 / 3.0 * np.pi * r**3
        izz = mc * r**2 / 2 + 0.4 * ms * r**2
        ixx = (mc * ((2 * h) ** 2 / 12 + r**2 / 4)
               + ms * (0.4 * r**2 + h**2 + 0.75 * h * r))
        return mc + ms, np.zeros(3), np.diag([ixx, ixx, izz])
    if g.type == T.BOX:
        a, b, c = g.size
        m = g.density * 8 * a * b * c
        return m, np.zeros(3), np.diag([
            m * (b**2 + c**2) / 3, m * (a**2 + c**2) / 3, m * (a**2 + b**2) / 3])
    raise ValueError(f"no mass for geom type {g.type}")


def body_mass_properties(geoms: Sequence[GeomSpec]):
    """Combine geoms (in body frame) -> (mass, com, inertia about com)."""
    if not geoms:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    total_m = 0.0
    com = np.zeros(3)
    parts = []
    for g in geoms:
        m, gc, I = geom_mass_inertia(g)
        R = _quat_mat(np.asarray(g.quat, float))
        c_body = np.asarray(g.pos, float) + R @ gc
        I_body = R @ I @ R.T
        parts.append((m, c_body, I_body))
        total_m += m
        com += m * c_body
    com /= total_m
    I_tot = np.zeros((3, 3))
    for m, c, I in parts:
        d = c - com
        I_tot += I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return total_m, com, I_tot


def build(bodies: List[BodySpec], actuators: List[Tuple[str, float]],
          static_boxes=None, init_qpos=None, **model_kwargs) -> T.Model:
    """actuators: list of (body_name, gear) applying torque to that body's
    (single-dof) joint."""
    name_to_idx = {b.name: i for i, b in enumerate(bodies)}
    nb = len(bodies)

    parent = np.array([name_to_idx[b.parent] if b.parent else -1 for b in bodies])
    for i, p in enumerate(parent):
        assert p < i, "bodies must be topologically ordered"

    jnt_type = np.array([b.joint.type for b in bodies])
    body_pos = np.array([b.pos for b in bodies], np.float32)
    body_quat = np.array([b.quat for b in bodies], np.float32)
    jnt_axis = np.array([np.asarray(b.joint.axis, float)
                         / max(np.linalg.norm(b.joint.axis), 1e-12)
                         for b in bodies], np.float32)
    jnt_pos = np.array([b.joint.pos for b in bodies], np.float32)

    mass = np.zeros(nb, np.float32)
    com = np.zeros((nb, 3), np.float32)
    inertia = np.zeros((nb, 3, 3), np.float32)
    for i, b in enumerate(bodies):
        if b.mass is not None:
            mass[i] = b.mass
            com[i] = b.com if b.com is not None else (0, 0, 0)
            inertia[i] = np.diag(b.inertia_diag if b.inertia_diag is not None
                                 else (1e-3, 1e-3, 1e-3))
        else:
            m, c, I = body_mass_properties(b.geoms)
            mass[i], com[i], inertia[i] = m, c, I
        if mass[i] <= 0:
            mass[i] = 1e-3
            inertia[i] = np.eye(3, dtype=np.float32) * 1e-4

    # qpos / dof layout
    jnt_qposadr = np.zeros(nb, np.int64)
    jnt_dofadr = np.zeros(nb, np.int64)
    nq = nv = 0
    dof_body, dof_armature, dof_damping, lim_lo, lim_hi = [], [], [], [], []
    for i, b in enumerate(bodies):
        jnt_qposadr[i], jnt_dofadr[i] = nq, nv
        if b.joint.type == T.FREE:
            nq += 7
            nv += 6
            for _ in range(6):
                dof_body.append(i)
                dof_armature.append(0.0)
                dof_damping.append(0.0)
                lim_lo.append(-np.inf)
                lim_hi.append(np.inf)
        elif b.joint.type in (T.HINGE, T.SLIDE):
            nq += 1
            nv += 1
            dof_body.append(i)
            dof_armature.append(b.joint.armature)
            dof_damping.append(b.joint.damping)
            lo, hi = b.joint.limit if b.joint.limit else (-np.inf, np.inf)
            lim_lo.append(lo)
            lim_hi.append(hi)

    # geoms flattened
    geom_body, geom_type, geom_pos, geom_quat, geom_size, geom_fric = [], [], [], [], [], []
    for i, b in enumerate(bodies):
        for g in b.geoms:
            geom_body.append(i)
            geom_type.append(g.type)
            geom_pos.append(g.pos)
            geom_quat.append(g.quat)
            size = list(g.size) + [0.0] * (3 - len(g.size))
            geom_size.append(size)
            geom_fric.append(g.friction)
    ng = len(geom_body)

    if static_boxes is None or len(static_boxes) == 0:
        sb_min = np.zeros((0, 3), np.float32)
        sb_max = np.zeros((0, 3), np.float32)
    else:
        sb = np.asarray(static_boxes, np.float32)   # [n, 2, 3] (min, max)
        sb_min, sb_max = sb[:, 0], sb[:, 1]

    # actuators: tuple (body_name, gear) -> torque motor; dict with keys
    # {body, kp, kd, force} -> position servo
    act_dof, act_gear, act_type, act_kp, act_kd, act_force = [], [], [], [], [], []
    for a in actuators:
        if isinstance(a, dict):
            act_dof.append(jnt_dofadr[name_to_idx[a["body"]]])
            act_gear.append(1.0)
            act_type.append(1)
            act_kp.append(a.get("kp", 100.0))
            act_kd.append(a.get("kd", 20.0))
            act_force.append(a.get("force", 100.0))
        else:
            n, g = a
            act_dof.append(jnt_dofadr[name_to_idx[n]])
            act_gear.append(g)
            act_type.append(0)
            act_kp.append(0.0)
            act_kd.append(0.0)
            act_force.append(0.0)
    act_dof = np.array(act_dof, np.int64)
    act_gear = np.array(act_gear, np.float32)

    if init_qpos is None:
        init_qpos = np.zeros(nq, np.float32)
        for i, b in enumerate(bodies):
            if b.joint.type == T.FREE:
                init_qpos[jnt_qposadr[i] + 3] = 1.0  # identity quat

    return T.Model(
        parent=parent, jnt_type=jnt_type, body_pos=body_pos, body_quat=body_quat,
        jnt_axis=jnt_axis, jnt_pos=jnt_pos, mass=mass, com=com, inertia=inertia,
        dof_body=np.array(dof_body), dof_armature=np.array(dof_armature, np.float32),
        dof_damping=np.array(dof_damping, np.float32),
        dof_limit_lo=np.array(lim_lo, np.float32),
        dof_limit_hi=np.array(lim_hi, np.float32),
        jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr, nq=nq, nv=nv, nb=nb,
        geom_body=np.array(geom_body), geom_type=np.array(geom_type),
        geom_pos=np.array(geom_pos, np.float32),
        geom_quat=np.array(geom_quat, np.float32),
        geom_size=np.array(geom_size, np.float32),
        geom_friction=np.array(geom_fric, np.float32), ng=ng,
        static_box_min=sb_min, static_box_max=sb_max, nsb=len(sb_min),
        act_dof=act_dof, act_gear=act_gear,
        act_type=np.array(act_type, np.int64),
        act_kp=np.array(act_kp, np.float32),
        act_kd=np.array(act_kd, np.float32),
        act_force=np.array(act_force, np.float32), nu=len(act_dof),
        init_qpos=np.asarray(init_qpos, np.float32),
        init_qvel=np.zeros(nv, np.float32),
        **model_kwargs,
    )
