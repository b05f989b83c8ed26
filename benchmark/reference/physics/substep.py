"""The rigid-body substep in plain PyTorch, the model check, and the
constants that the CUDA kernel bakes in.

Counterpart of `ddiffpg_tpu/physics/pallas_ant.py:make_substep_kernel`
(the one TPU kernel of the JAX package). That Pallas kernel runs
`n_substeps` rigid-body substeps per env in one launch; on an NVIDIA card
the same function is `csrc/substep.cu`, loaded by `substep_cuda.py`.
This module holds:

* `check_supported` — the Pallas kernel's model class
  (`pallas_ant.py:_check_supported`): FREE joints only at roots; HINGE,
  SLIDE and FIXED joints anywhere, several roots allowed; joints anchored
  at the body origin; at most 32 bodies; sphere/capsule probes, dynamic
  BOX geoms, torque motors and PD position servos. Anything else raises
  `NotImplementedError`; nothing falls back.
* `SubstepConstants` — every model constant as the float32 value the
  Pallas trace would bake in (Python doubles rounded once to f32), shared
  by this module and the CUDA kernel's `__constant__` block.
* `substep_reference` — the substep on `[B]` row tensors in the kernel's
  stage and summation order. It is the oracle of the kernel's checks and
  the physics of an env that lives on the CPU.

No gradient flows through the physics (the JAX package never
differentiates it), so neither version has a backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.physics.types import (BOX, CAPSULE, FIXED, FREE,
                                             HINGE, SLIDE, SPHERE, Model)

# ---------------------------------------------------------------------------
# model check and constants

ONE_DOF = (HINGE, SLIDE)
NDOF = {FREE: 6, HINGE: 1, SLIDE: 1, FIXED: 0}


def check_supported(m: Model) -> None:
    """Raise NotImplementedError unless `m` is in the kernel's model class."""
    for i in range(m.nb):
        t = int(m.jnt_type[i])
        if t not in NDOF:
            raise NotImplementedError(f"substep: joint type {t} on body {i}")
        if t == FREE and int(m.parent[i]) >= 0:
            raise NotImplementedError("substep: FREE joints only at roots")
    if not np.allclose(m.jnt_pos, 0.0):
        raise NotImplementedError("substep: joints must anchor at the body "
                                  "origin")
    if m.nb > 32:
        raise NotImplementedError("substep: at most 32 bodies")
    for a in np.asarray(m.act_type):
        if int(a) not in (0, 1):
            raise NotImplementedError(f"substep: actuator type {int(a)}")
    for gi in range(m.ng):
        t = int(m.geom_type[gi])
        if t not in (SPHERE, CAPSULE, BOX):
            raise NotImplementedError(f"substep: geom type {t}")


def _f32(x) -> float:
    return float(np.float32(x))


def _is_ident(q) -> bool:
    return bool(abs(q[0] - 1.0) < 1e-12
                and abs(q[1]) + abs(q[2]) + abs(q[3]) < 1e-12)


@dataclass(frozen=True)
class SubstepConstants:
    """Model constants as float32 values, in the layout of the kernel."""
    nb: int
    nv: int
    nq: int
    nu: int
    npr: int
    nsb: int
    ndb: int                        # dynamic (body-attached) boxes
    n_substeps: int
    parent: Tuple[int, ...]
    jnt_type: Tuple[int, ...]       # [nb]
    qposadr: Tuple[int, ...]        # [nb]
    dofadr: Tuple[int, ...]         # [nb]
    dof_body: Tuple[int, ...]       # [nv]
    ident_quat: Tuple[bool, ...]
    anc_mask: Tuple[int, ...]       # bit j: body j lies on the path root..i
    axis: np.ndarray                # [nb, 3]
    body_pos: np.ndarray            # [nb, 3]
    body_quat: np.ndarray           # [nb, 4]
    mass: np.ndarray                # [nb]
    com: np.ndarray                 # [nb, 3]
    inertia: np.ndarray             # [nb, 3, 3]
    damping: np.ndarray             # [nv]
    armature: np.ndarray            # [nv]
    lim_lo: np.ndarray              # [nv]
    lim_hi: np.ndarray              # [nv]
    lim_on: Tuple[bool, ...]        # [nv] a finite limit exists
    act_dof: Tuple[int, ...]        # [nu]
    act_gear: np.ndarray            # [nu]
    act_type: Tuple[int, ...]       # [nu] 0 torque motor, 1 PD servo
    act_kp: np.ndarray              # [nu]
    act_kd: np.ndarray              # [nu]
    act_force: np.ndarray           # [nu] servo force limit
    act_qadr: Tuple[int, ...]       # [nu] qpos index of the servo's joint
    probe_body: Tuple[int, ...]     # [npr]
    probe_off: np.ndarray           # [npr, 3]
    probe_rad: np.ndarray           # [npr]
    probe_fric: np.ndarray          # [npr]
    probe_kn: np.ndarray            # [npr]
    probe_cn: np.ndarray            # [npr]
    box_min: np.ndarray             # [nsb, 3]
    box_max: np.ndarray             # [nsb, 3]
    # dynamic boxes (pallas_ant.py:176-184). Their contacts use the probe's
    # friction, as the Pallas kernel does, so the box's own is not kept.
    dbox_body: Tuple[int, ...]      # [ndb]
    dbox_ident: Tuple[bool, ...]    # [ndb] local quat has zero vector part
    dbox_pos: np.ndarray            # [ndb, 3] in the body frame
    dbox_quat: np.ndarray           # [ndb, 4] in the body frame
    dbox_half: np.ndarray           # [ndb, 3] half extents
    dbox_keep: np.ndarray           # [ndb, npr] 0 for the box body's probes
    gravity: Tuple[float, float, float]
    dt: float
    inv_nb: float
    capk_scale: float               # 1 / (omega^2 dt): impulse cap per k_n
    inv_vreb: float
    vreb: float
    vtol: float
    vtol_eps: float                 # vtol^2 * 1e-4
    lim_k: float
    lim_c: float
    vmax: float
    support_f: float                # 2 m_total |g|
    m_total: float
    inv_m_total: float

    @property
    def has_servo(self) -> bool:
        return 1 in self.act_type

    @staticmethod
    def from_model(m: Model, n_substeps: int | None = None
                   ) -> "SubstepConstants":
        check_supported(m)
        nb = m.nb
        f32 = lambda a: np.asarray(a, np.float32)
        parent = tuple(int(p) for p in m.parent)
        anc = []
        for i in range(nb):
            mask, b = 0, i
            while b >= 0:
                mask |= 1 << b
                b = parent[b]
            anc.append(mask)
        bq = np.asarray(m.body_quat, np.float64)
        omega_c = 1.0 / float(m.contact_timeconst)
        zeta = float(m.contact_dampratio)
        dt = float(m.dt)
        # probes: sphere centres and both capsule end caps, geoms in order
        # (pallas_ant.py:194-212); offsets in f64, then rounded to f32
        pb, poff, prad, pfr, pkn, pcn = [], [], [], [], [], []
        dboxes = []
        for gi in range(m.ng):
            b = int(m.geom_body[gi])
            gp = [float(x) for x in m.geom_pos[gi]]
            if int(m.geom_type[gi]) == BOX:
                dboxes.append((b, gp, [float(x) for x in m.geom_quat[gi]],
                               [float(x) for x in m.geom_size[gi]]))
                continue
            r = float(m.geom_size[gi][0])
            fr = float(m.geom_friction[gi])
            offs = []
            if int(m.geom_type[gi]) == SPHERE:
                offs.append(gp)
            else:
                h = float(m.geom_size[gi][1])
                w, x, y, z = np.asarray(m.geom_quat[gi], np.float64)
                zax = (2 * (x * z + w * y), 2 * (y * z - w * x),
                       1 - 2 * (x * x + y * y))
                for sgn in (1.0, -1.0):
                    offs.append([gp[k] + sgn * h * zax[k] for k in range(3)])
            me = float(m.mass[b])
            for off in offs:
                pb.append(b)
                poff.append(off)
                prad.append(r)
                pfr.append(fr)
                pkn.append(me * omega_c * omega_c)
                pcn.append(2.0 * zeta * me * omega_c)
        masses = [float(x) for x in m.mass]
        m_total = float(sum(masses))
        gravity = tuple(float(g) for g in m.gravity)
        inv_vreb = 1.0 / float(m.contact_maxrebound)
        vtol = float(m.friction_vel_tol)
        lo, hi = f32(m.dof_limit_lo), f32(m.dof_limit_hi)
        qposadr = tuple(int(x) for x in m.jnt_qposadr)
        dof_body = tuple(int(x) for x in m.dof_body)
        keep = np.ones((len(dboxes), len(pb)), np.float32)
        for j, (b2, _, _, _) in enumerate(dboxes):
            keep[j, [k for k, b in enumerate(pb) if b == b2]] = 0.0
        return SubstepConstants(
            nb=nb, nv=m.nv, nq=m.nq, nu=m.nu, npr=len(pb), nsb=m.nsb,
            ndb=len(dboxes),
            n_substeps=int(n_substeps if n_substeps is not None
                           else m.n_substeps),
            parent=parent, jnt_type=tuple(int(t) for t in m.jnt_type),
            qposadr=qposadr, dofadr=tuple(int(x) for x in m.jnt_dofadr),
            dof_body=dof_body,
            ident_quat=tuple(_is_ident(q) for q in bq), anc_mask=tuple(anc),
            axis=f32(m.jnt_axis), body_pos=f32(m.body_pos),
            body_quat=f32(m.body_quat), mass=f32(m.mass), com=f32(m.com),
            inertia=f32(m.inertia), damping=f32(m.dof_damping),
            armature=f32(m.dof_armature), lim_lo=lo, lim_hi=hi,
            lim_on=tuple(bool(np.isfinite(a) or np.isfinite(b_))
                         for a, b_ in zip(lo, hi)),
            act_dof=tuple(int(d) for d in m.act_dof),
            act_gear=f32(m.act_gear),
            act_type=tuple(int(t) for t in m.act_type),
            act_kp=f32(m.act_kp), act_kd=f32(m.act_kd),
            act_force=f32(m.act_force),
            act_qadr=tuple(qposadr[dof_body[int(d)]] for d in m.act_dof),
            probe_body=tuple(pb), probe_off=f32(poff).reshape(-1, 3),
            probe_rad=f32(prad), probe_fric=f32(pfr), probe_kn=f32(pkn),
            probe_cn=f32(pcn),
            box_min=f32(m.static_box_min).reshape(-1, 3),
            box_max=f32(m.static_box_max).reshape(-1, 3),
            dbox_body=tuple(b for b, _, _, _ in dboxes),
            dbox_ident=tuple(all(abs(x) < 1e-12 for x in q[1:])
                             for _, _, q, _ in dboxes),
            dbox_pos=f32([p for _, p, _, _ in dboxes]).reshape(-1, 3),
            dbox_quat=f32([q for _, _, q, _ in dboxes]).reshape(-1, 4),
            dbox_half=f32([h for _, _, _, h in dboxes]).reshape(-1, 3),
            dbox_keep=keep,
            gravity=tuple(_f32(g) for g in gravity), dt=_f32(dt),
            inv_nb=_f32(1.0 / nb),
            capk_scale=_f32(1.0 / (omega_c * omega_c * dt)),
            inv_vreb=_f32(inv_vreb), vreb=_f32(1.0 / inv_vreb),
            vtol=_f32(vtol), vtol_eps=_f32(vtol * vtol * 1e-4),
            lim_k=_f32(m.limit_stiffness), lim_c=_f32(m.limit_damping),
            vmax=_f32(m.max_qvel),
            support_f=_f32(2.0 * m_total * abs(gravity[2])),
            m_total=_f32(m_total), inv_m_total=_f32(1.0 / m_total))


# ---------------------------------------------------------------------------
# tuple math on [B] row tensors (same formulas and order as the kernel)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def qmul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return (w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)


def qrot(q, v):
    qv = (q[1], q[2], q[3])
    t = vscale(vcross(qv, v), 2.0)
    return vadd(vadd(v, vscale(t, q[0])), vcross(qv, t))


def qmat(q):
    w, x, y, z = q
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def _sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def m3vec(R, v):
    return tuple(_sum([R[i][k] * v[k] for k in range(3)]) for i in range(3))


def m3mul(A, B):
    return tuple(tuple(_sum([A[i][k] * B[k][j] for k in range(3)])
                       for j in range(3)) for i in range(3))


def m3mulT(A, B):
    """A @ B^T."""
    return tuple(tuple(_sum([A[i][k] * B[j][k] for k in range(3)])
                       for j in range(3)) for i in range(3))


def sv_add(a, b):
    return (vadd(a[0], b[0]), vadd(a[1], b[1]))


def sv_scale(a, s):
    return (vscale(a[0], s), vscale(a[1], s))


def cross_motion(v, m):
    w, vo = v
    mw, mv = m
    return (vcross(w, mw), vadd(vcross(w, mv), vcross(vo, mw)))


def cross_force(v, f):
    w, vo = v
    n, fl = f
    return (vadd(vcross(w, n), vcross(vo, fl)), vcross(w, fl))


def i6vec(blk, sv):
    a = list(sv[0]) + list(sv[1])
    out = [_sum([blk[r][c] * a[c] for c in range(6)]) for r in range(6)]
    return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _relu(x):
    return torch.clamp(x, min=0.0)


def _nearest_face(fl, like):
    """Outward normal of the nearest face (first in face order on ties) of
    a box, from the six face distances `fl` (-x, +x, -y, +y, -z, +z)."""
    d_in = fl[0]
    for f_ in fl[1:]:
        d_in = torch.minimum(d_in, f_)
    normals = [(-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
               (0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (0.0, 0.0, 1.0)]
    nxi = torch.zeros_like(like)
    nyi = torch.zeros_like(like)
    nzi = torch.zeros_like(like)
    chosen = torch.zeros_like(like, dtype=torch.bool)
    for f_, (a1, a2, a3) in zip(fl, normals):
        hit = (f_ <= d_in) & ~chosen
        nxi = torch.where(hit, a1, nxi)
        nyi = torch.where(hit, a2, nyi)
        nzi = torch.where(hit, a3, nzi)
        chosen = chosen | hit
    return d_in, (nxi, nyi, nzi)


# ---------------------------------------------------------------------------
# the substep


def _tup(a) -> tuple:
    return tuple(float(x) for x in a)


def _substep(c: SubstepConstants, q: List[torch.Tensor],
             qd: List[torch.Tensor], ctrl: List[torch.Tensor], pk: dict):
    nb, nv = c.nb, c.nv
    dt = c.dt
    zero = torch.zeros_like(q[0])
    one = zero + 1.0
    z3 = (zero, zero, zero)
    jt, qadr, dadr = c.jnt_type, c.qposadr, c.dofadr
    frees = [i for i in range(nb) if jt[i] == FREE]
    one_dof = [i for i in range(nb) if jt[i] in ONE_DOF]

    # ---------------- FK (FREE roots, HINGE, SLIDE, FIXED)
    pos: list = [None] * nb
    quat: list = [None] * nb
    for i in range(nb):
        qa = qadr[i]
        if jt[i] == FREE:
            pos[i] = (q[qa], q[qa + 1], q[qa + 2])
            quat[i] = (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6])
            continue
        p = c.parent[i]
        if p >= 0:
            p0 = vadd(pos[p], qrot(quat[p], _tup(c.body_pos[i])))
            q0 = quat[p] if c.ident_quat[i] else qmul(quat[p],
                                                      _tup(c.body_quat[i]))
        else:   # a non-FREE root keeps its constant frame
            p0 = tuple(zero + x for x in _tup(c.body_pos[i]))
            q0 = tuple(zero + x for x in _tup(c.body_quat[i]))
        if jt[i] == HINGE:
            half = q[qa] * 0.5
            s = torch.sin(half)
            ax = _tup(c.axis[i])
            qj = (torch.cos(half), ax[0] * s, ax[1] * s, ax[2] * s)
            quat[i] = qmul(q0, qj)
            pos[i] = p0
        elif jt[i] == SLIDE:
            ax_w = qrot(q0, _tup(c.axis[i]))
            pos[i] = vadd(p0, vscale(ax_w, q[qa]))
            quat[i] = q0
        else:   # FIXED
            pos[i] = p0
            quat[i] = q0

    # ---------------- robot-centred frame about the body centroid p0
    p0 = tuple(_sum([pos[i][k] for i in range(nb)]) * c.inv_nb
               for k in range(3))
    posr = [vsub(pos[i], p0) for i in range(nb)]

    # ---------------- motion subspaces
    S: list = [None] * nv
    for i in frees:
        d = dadr[i]
        for k in range(3):
            e = [zero, zero, zero]
            e[k] = one
            S[d + k] = (z3, tuple(e))
            S[d + 3 + k] = (tuple(e), z3)
    for i in one_dof:
        w = qrot(quat[i], _tup(c.axis[i]))
        S[dadr[i]] = (w, vcross(posr[i], w)) if jt[i] == HINGE else (z3, w)

    # ---------------- qvel -> u (free joints: (v_origin, omega))
    u = list(qd)
    for i in frees:
        d = dadr[i]
        wroot = (qd[d + 3], qd[d + 4], qd[d + 5])
        u[d], u[d + 1], u[d + 2] = vsub((qd[d], qd[d + 1], qd[d + 2]),
                                        vcross(wroot, posr[i]))

    # ---------------- body spatial velocities
    V: list = [None] * nb
    for i in range(nb):
        p = c.parent[i]
        base = V[p] if p >= 0 else (z3, z3)
        if jt[i] == FREE:
            d = dadr[i]
            V[i] = ((u[d + 3], u[d + 4], u[d + 5]), (u[d], u[d + 1], u[d + 2]))
        elif jt[i] in ONE_DOF:
            V[i] = sv_add(base, sv_scale(S[dadr[i]], u[dadr[i]]))
        else:   # FIXED: the parent's motion
            V[i] = base

    # ---------------- 6x6 spatial inertias about p0
    I6: list = [None] * nb
    for i in range(nb):
        R = qmat(quat[i])
        cc_ = vadd(posr[i], m3vec(R, _tup(c.com[i])))
        inert = tuple(_tup(r) for r in c.inertia[i])
        Ic = m3mulT(m3mul(R, inert), R)
        mi = float(c.mass[i])
        cx = ((zero, -cc_[2], cc_[1]), (cc_[2], zero, -cc_[0]),
              (-cc_[1], cc_[0], zero))
        cxcx = m3mul(cx, cx)
        blk = [[None] * 6 for _ in range(6)]
        for r in range(3):
            for k in range(3):
                blk[r][k] = Ic[r][k] - mi * cxcx[r][k]
                blk[r][3 + k] = mi * cx[r][k]
                blk[3 + r][k] = -mi * cx[r][k]
                blk[3 + r][3 + k] = (zero + mi) if r == k else zero
        I6[i] = blk

    # ---------------- contacts: probes vs plane + static boxes, [npr, B]
    px_l, py_l, pz_l, vx_l, vy_l, vz_l, vbx_l, vby_l, vbz_l = (
        [] for _ in range(9))
    for k in range(c.npr):
        b = c.probe_body[k]
        rq = qrot(quat[b], _tup(c.probe_off[k]))
        pw = vadd(pos[b], rq)
        w, vo_b = V[b]
        vv = vadd(vo_b, vcross(w, vadd(posr[b], rq)))
        vb = vadd(vo_b, vcross(w, posr[b]))
        for lst, val in zip((px_l, py_l, pz_l, vx_l, vy_l, vz_l,
                             vbx_l, vby_l, vbz_l), pw + vv + vb):
            lst.append(val)
    px, py, pz, vx, vy, vz, vbx, vby, vbz = (
        torch.stack(lst) for lst in (px_l, py_l, pz_l, vx_l, vy_l, vz_l,
                                     vbx_l, vby_l, vbz_l))
    pxr, pyr, pzr = px - p0[0], py - p0[1], pz - p0[2]
    rad, fric, k_n, c_n = pk["rad"], pk["fric"], pk["kn"], pk["cn"]
    cap_k = k_n * c.capk_scale

    def normal_force(dist, v_n):
        pen = _relu(-dist)
        f_n = _relu(k_n * pen - c_n * v_n)
        f_n = torch.where(pen > 0, f_n, 0.0)
        # separation gate (strictly dissipative impacts) and impulse cap
        f_n = f_n * _clip(1.0 - v_n * c.inv_vreb, 0.0, 1.0)
        return pen, torch.minimum(f_n, _relu(cap_k * (c.vreb - v_n)))

    def friction(f_n, rvx, rvy, rvz, v_n, nx, ny, nz):
        tx = rvx - v_n * nx
        ty = rvy - v_n * ny
        tz = rvz - v_n * nz
        vt = torch.sqrt(tx * tx + ty * ty + tz * tz + c.vtol_eps)
        scale = torch.clamp(vt / c.vtol, max=1.0)
        ft = -fric * f_n * scale / vt
        return f_n * nx + ft * tx, f_n * ny + ft * ty, f_n * nz + ft * tz

    def contact_force(dist, nx, ny, nz):
        v_n = vx * nx + vy * ny + vz * nz
        pen, f_n = normal_force(dist, v_n)
        gx, gy, gz = friction(f_n, vx, vy, vz, v_n, nx, ny, nz)
        v_cn = vbx * nx + vby * ny + vbz * nz
        # 1e9 sentinel for probes not in contact (round-3 catapult fix)
        return gx, gy, gz, f_n, torch.where(pen > 0, v_cn, 1e9)

    fx, fy, fz, imp_pt, vmin_pt = contact_force(pz - rad, 0.0, 0.0, 1.0)
    for j in range(c.nsb):
        bmin, bmax = _tup(c.box_min[j]), _tup(c.box_max[j])
        dx = px - _clip(px, bmin[0], bmax[0])
        dy = py - _clip(py, bmin[1], bmax[1])
        dz = pz - _clip(pz, bmin[2], bmax[2])
        d_out = torch.sqrt(dx * dx + dy * dy + dz * dz)
        outside = d_out > 1e-9
        inv = 1.0 / torch.where(outside, d_out, 1.0)
        d_in, (nxi, nyi, nzi) = _nearest_face(
            [px - bmin[0], bmax[0] - px, py - bmin[1], bmax[1] - py,
             pz - bmin[2], bmax[2] - pz], px)
        nx = torch.where(outside, dx * inv, nxi)
        ny = torch.where(outside, dy * inv, nyi)
        nz = torch.where(outside, dz * inv, nzi)
        dist = torch.where(outside, d_out, -d_in) - rad
        gx, gy, gz, g_fn, g_vn = contact_force(dist, nx, ny, nz)
        fx = fx + gx
        fy = fy + gy
        fz = fz + gz
        imp_pt = imp_pt + g_fn
        vmin_pt = torch.minimum(vmin_pt, g_vn)

    # per-body world-contact impulse budget, probes summed in index order
    s_rows: list = [None] * c.npr
    for b in range(nb):
        rows = [k for k in range(c.npr) if c.probe_body[k] == b]
        if not rows:
            continue
        imp_b = imp_pt[rows[0]]
        vmin_b = vmin_pt[rows[0]]
        for r in rows[1:]:
            imp_b = imp_b + imp_pt[r]
            vmin_b = torch.minimum(vmin_b, vmin_pt[r])
        fade_b = _clip(1.0 - vmin_b * c.inv_vreb, 0.0, 1.0)
        allow_b = c.support_f * fade_b + float(c.mass[b]) * _relu(
            c.vreb - vmin_b) / dt
        s_b = torch.clamp(allow_b / torch.clamp(imp_b, min=1e-9), max=1.0)
        for r in rows:
            s_rows[r] = s_b
    s_pt = torch.stack(s_rows)
    fx = fx * s_pt
    fy = fy * s_pt
    fz = fz * s_pt

    # global vertical-thrust budget against the COM vertical velocity
    vz_com = None
    for b in range(nb):
        w_b, vo_b = V[b]
        vb_z = vadd(vo_b, vcross(w_b, posr[b]))[2]
        term = vb_z * float(c.mass[b])
        vz_com = term if vz_com is None else vz_com + term
    vz_com = vz_com * c.inv_m_total
    up_fade = _clip(1.0 - vz_com * c.inv_vreb, 0.0, 1.0)
    allow_up = c.support_f * up_fade + c.m_total * _relu(c.vreb - vz_com) / dt
    fz_pos = _relu(fz)
    f_up = _sum([fz_pos[k] for k in range(c.npr)])
    s_up = torch.clamp(allow_up / torch.clamp(f_up, min=1e-9), max=1.0)
    fz = torch.where(fz > 0, fz * s_up, fz)

    # ---------------- dynamic OBBs (stage g, after both budgets): probes in
    # the box frame; the reaction, summed over probes, acts on the box body
    f_ext = [(z3, z3) for _ in range(nb)]
    for j in range(c.ndb):
        b2 = c.dbox_body[j]
        half = _tup(c.dbox_half[j])
        bq = quat[b2] if c.dbox_ident[j] else qmul(quat[b2],
                                                   _tup(c.dbox_quat[j]))
        bp = vadd(pos[b2], qrot(quat[b2], _tup(c.dbox_pos[j])))
        cbq = (bq[0], -bq[1], -bq[2], -bq[3])
        lx, ly, lz = qrot(cbq, (px - bp[0], py - bp[1], pz - bp[2]))
        dx = lx - _clip(lx, -half[0], half[0])
        dy = ly - _clip(ly, -half[1], half[1])
        dz = lz - _clip(lz, -half[2], half[2])
        d_out = torch.sqrt(dx * dx + dy * dy + dz * dz)
        outside = d_out > 1e-9
        inv = 1.0 / torch.where(outside, d_out, 1.0)
        d_in, (nxi, nyi, nzi) = _nearest_face(
            [lx + half[0], half[0] - lx, ly + half[1], half[1] - ly,
             lz + half[2], half[2] - lz], px)
        nx, ny, nz = qrot(bq, (torch.where(outside, dx * inv, nxi),
                               torch.where(outside, dy * inv, nyi),
                               torch.where(outside, dz * inv, nzi)))
        dist = torch.where(outside, d_out, -d_in) - rad
        # relative velocity: probe minus the box body's point velocity
        wb, vob = V[b2]
        rvx = vx - (vob[0] + wb[1] * pzr - wb[2] * pyr)
        rvy = vy - (vob[1] + wb[2] * pxr - wb[0] * pzr)
        rvz = vz - (vob[2] + wb[0] * pyr - wb[1] * pxr)
        v_n = rvx * nx + rvy * ny + rvz * nz
        _, f_n = normal_force(dist, v_n)
        gx, gy, gz = friction(f_n, rvx, rvy, rvz, v_n, nx, ny, nz)
        keep = pk["keep"][j]      # the box body's own probes add nothing
        gx = gx * keep
        gy = gy * keep
        gz = gz * keep
        fx = fx + gx
        fy = fy + gy
        fz = fz + gz
        n_o = (pyr * gz - pzr * gy, pzr * gx - pxr * gz, pxr * gy - pyr * gx)
        react = tuple(_sum([t[k] for k in range(c.npr)])
                      for t in n_o + (gx, gy, gz))
        f_ext[b2] = sv_add(f_ext[b2], (tuple(zero - r for r in react[:3]),
                                       tuple(zero - r for r in react[3:])))

    # probe forces to bodies as [n_o; f] about p0, in probe order
    for k in range(c.npr):
        f = (fx[k], fy[k], fz[k])
        n_o = vcross((pxr[k], pyr[k], pzr[k]), f)
        b = c.probe_body[k]
        f_ext[b] = sv_add(f_ext[b], (n_o, f))

    # ---------------- bias forces (RNEA, qacc = 0)
    g = c.gravity
    a0 = (z3, (zero - g[0], zero - g[1], zero - g[2]))
    A: list = [None] * nb
    for i in range(nb):
        p = c.parent[i]
        if p < 0 or jt[i] == FREE:
            A[i] = a0
        elif jt[i] in ONE_DOF:
            A[i] = sv_add(A[p], cross_motion(V[p], sv_scale(S[dadr[i]],
                                                            u[dadr[i]])))
        else:   # FIXED
            A[i] = A[p]
    fb: list = [None] * nb
    for i in range(nb):
        net = sv_add(i6vec(I6[i], A[i]),
                     cross_force(V[i], i6vec(I6[i], V[i])))
        fb[i] = (vsub(net[0], f_ext[i][0]), vsub(net[1], f_ext[i][1]))
    for i in range(nb - 1, 0, -1):
        if c.parent[i] >= 0:
            fb[c.parent[i]] = sv_add(fb[c.parent[i]], fb[i])
    dof_body = c.dof_body

    def project(f6):
        """Per-dof S^T f of a per-body spatial force (tau_bias, tau_grav)."""
        return [vdot(S[d][0], f6[dof_body[d]][0])
                + vdot(S[d][1], f6[dof_body[d]][1]) for d in range(nv)]

    tau_bias = project(fb)

    # ---------------- CRBA mass matrix (composite inertias), lower triangle
    Icomp = [[list(r) for r in I6[i]] for i in range(nb)]
    for i in range(nb - 1, 0, -1):
        p = c.parent[i]
        if p < 0:
            continue
        for r in range(6):
            for k in range(6):
                Icomp[p][r][k] = Icomp[p][r][k] + Icomp[i][r][k]
    M = [[zero] * nv for _ in range(nv)]
    for d in range(nv):
        F6 = i6vec(Icomp[dof_body[d]], S[d])
        for e in range(d + 1):
            if not (c.anc_mask[dof_body[d]] >> dof_body[e]) & 1:
                continue
            val = vdot(S[e][0], F6[0]) + vdot(S[e][1], F6[1])
            if d == e:
                val = val + float(c.armature[d])
            M[d][e] = val

    # ---------------- gravity compensation of the servos: the zero-velocity,
    # no-contact RNEA, i.e. subtree sums of I6 a0 (pallas_ant.py:664-678)
    if c.has_servo:
        fg = [i6vec(I6[i], a0) for i in range(nb)]
        for i in range(nb - 1, 0, -1):
            if c.parent[i] >= 0:
                fg[c.parent[i]] = sv_add(fg[c.parent[i]], fg[i])
        tau_grav = project(fg)

    # ---------------- applied + passive torques
    tau = [zero - float(c.damping[d]) * u[d] for d in range(nv)]
    for a_i, d in enumerate(c.act_dof):
        if c.act_type[a_i] == 1:    # PD position servo, force-limited
            f = float(c.act_kp[a_i]) * (ctrl[a_i] - q[c.act_qadr[a_i]]) \
                - float(c.act_kd[a_i]) * u[d] + tau_grav[d]
            lim = float(c.act_force[a_i])
            tau[d] = tau[d] + _clip(f, -lim, lim)
        else:                       # direct torque motor
            tau[d] = tau[d] + float(c.act_gear[a_i]) * _clip(ctrl[a_i],
                                                             -1.0, 1.0)
    for i in one_dof:
        d = dadr[i]
        if not c.lim_on[d]:
            continue
        qi = q[qadr[i]]
        over = _relu(qi - float(c.lim_hi[d]))
        under = _relu(float(c.lim_lo[d]) - qi)
        active = (over > 0) | (under > 0)
        tau[d] = tau[d] - c.lim_k * (over - under) \
            - torch.where(active, c.lim_c * u[d], 0.0)
    rhs = [tau[d] - tau_bias[d] for d in range(nv)]

    # ---------------- Cholesky solve, in place on the lower triangle
    L = M
    for j in range(nv):
        dj = torch.sqrt(torch.clamp(L[j][j], min=1e-9))
        inv_dj = 1.0 / dj
        for i2 in range(j, nv):
            L[i2][j] = L[i2][j] * inv_dj
        for i2 in range(j + 1, nv):
            for k2 in range(j + 1, i2 + 1):
                L[i2][k2] = L[i2][k2] - L[i2][j] * L[k2][j]
    y: list = [None] * nv
    for i2 in range(nv):
        acc = rhs[i2]
        for k2 in range(i2):
            acc = acc - L[i2][k2] * y[k2]
        y[i2] = acc / L[i2][i2]
    ud: list = [None] * nv
    for i2 in range(nv - 1, -1, -1):
        acc = y[i2]
        for k2 in range(i2 + 1, nv):
            acc = acc - L[k2][i2] * ud[k2]
        ud[i2] = acc / L[i2][i2]

    # ---------------- integrate (semi-implicit, hard velocity clamps)
    vmax = c.vmax
    u_new = [_clip(u[d] + dt * ud[d], -vmax, vmax) for d in range(nv)]
    qd_new = list(u_new)
    q_new = list(q)
    for i in frees:
        d, qa = dadr[i], qadr[i]
        w_new = (u_new[d + 3], u_new[d + 4], u_new[d + 5])
        vp_new = vadd((u_new[d], u_new[d + 1], u_new[d + 2]),
                      vcross(w_new, posr[i]))
        vp_new = tuple(_clip(v, -vmax, vmax) for v in vp_new)
        qd_new[d], qd_new[d + 1], qd_new[d + 2] = vp_new
        for k in range(3):
            q_new[qa + k] = q[qa + k] + dt * vp_new[k]
        angle = torch.sqrt(w_new[0] * w_new[0] + w_new[1] * w_new[1]
                           + w_new[2] * w_new[2])
        safe = torch.where(angle > 1e-9, angle, 1.0)
        ax = (w_new[0] / safe, w_new[1] / safe, w_new[2] / safe)
        half = angle * dt * 0.5
        sh = torch.sin(half)
        dq = (torch.cos(half), ax[0] * sh, ax[1] * sh, ax[2] * sh)
        qn = qmul(dq, (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]))
        norm = torch.sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2]
                          + qn[3] * qn[3])
        for k in range(4):
            q_new[qa + 3 + k] = qn[k] / norm
    for i in one_dof:
        qa, d = qadr[i], dadr[i]
        q_new[qa] = q[qa] + dt * qd_new[d]
        if c.lim_on[d]:
            lo, hi = float(c.lim_lo[d]), float(c.lim_hi[d])
            qv_ = q_new[qa]
            qdv = qd_new[d]
            qdv = torch.where(qv_ < lo, _relu(qdv), qdv)
            qdv = torch.where(qv_ > hi, torch.clamp(qdv, max=0.0), qdv)
            q_new[qa] = _clip(qv_, lo, hi)
            qd_new[d] = qdv
    return q_new, qd_new


def substep_reference(model, qpos: torch.Tensor, qvel: torch.Tensor,
                      ctrl: torch.Tensor, n_substeps: int | None = None):
    """Plain PyTorch substeps: (qpos [B, nq], qvel [B, nv], ctrl [B, nu])
    -> (qpos, qvel) after `n_substeps` (default: the model's) substeps.

    `model` is a `Model` or its `SubstepConstants`. float32 throughout.
    """
    c = model if isinstance(model, SubstepConstants) \
        else SubstepConstants.from_model(model)
    n_sub = c.n_substeps if n_substeps is None else int(n_substeps)
    for name, t, w in (("qpos", qpos, c.nq), ("qvel", qvel, c.nv),
                       ("ctrl", ctrl, c.nu)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != w:
            raise ValueError(f"{name}: want float32 [B, {w}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    dev = qpos.device
    pk = {k: torch.tensor(getattr(c, "probe_" + k), dtype=torch.float32,
                          device=dev)[:, None]
          for k in ("rad", "fric", "kn", "cn")}
    pk["keep"] = torch.tensor(c.dbox_keep, dtype=torch.float32,
                              device=dev)[:, :, None]
    q = list(qpos.unbind(1))
    qd = list(qvel.unbind(1))
    ct = list(ctrl.unbind(1))
    for _ in range(n_sub):
        q, qd = _substep(c, q, qd, ct, pk)
    return torch.stack(q, 1), torch.stack(qd, 1)
