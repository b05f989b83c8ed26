"""The batched articulated engine in plain PyTorch, batch-leading `[B, ...]`.

Counterpart of `ddiffpg_tpu/physics/engine_cl.py`, the JAX package's XLA
engine: its envs step it whenever the Pallas kernel is off
(`use_pallas=False`, or "auto" on the CPU). Same math and stage order:
FK, the robot-centred frame about the body centroid, motion subspaces and
body velocities, 6x6 spatial inertias, penalty contacts (`contact_forces`:
the plane, the static world, dynamic OBB boxes, the per-body impulse
budget and the global vertical-thrust budget), RNEA bias forces with the
servos' gravity compensation, CRBA, the column Cholesky solve and the
clamped semi-implicit integration. The JAX engine keeps the env batch on
the minor axis (`[nb, 3, B]`, `[nv, nv, B]`) so that the TPU's 128 lanes
fill with envs; on the card the batch leads, as everywhere in the port.

It is not the substep kernel's twin. Where the model carries a wall SDF
(the mazes, `physics/maze.py:compile_sdf`), the walls are one bilinear
SDF lookup per probe; the kernel and `physics/substep.py` test the wall
AABBs. A model without an SDF takes the AABB branch here too.

`Engine` holds a model's index and constant tensors on one device, built
once (an env holds one, so that a step uploads nothing), on
`physics/engine.py:Kinematics` (its level tables, motion subspaces and
qvel -> u). An eager step is thousands of small launches, so the engine
keeps their count down where that costs no accuracy: a quaternion product
or a rotation matrix is one contraction with a constant sign table, a
capsule's probe is one rotated body-frame offset, the dynamic boxes are
one batch, and the forward substitution rides the Cholesky's column loop.
Every reduction that the JAX engine scatters (`segment_sum`,
`segment_max`, `.at[body].add`) runs over a static member table in a
fixed order: no float atomics, so two calls on the same inputs are
bitwise equal on the card. No matmul runs, so TF32 cannot enter. On a
CUDA device `Engine.graphed_step` replays one CUDA graph per batch size,
captured on first use: the counterpart of JAX jitting `step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ddiffpg_tpu_torch.physics import quat as Q
from ddiffpg_tpu_torch.physics.engine import Kinematics, _structure
from ddiffpg_tpu_torch.physics.types import (BOX, CAPSULE, FREE, HINGE, SLIDE,
                                             SPHERE, Model)

INF = float("inf")


def _tables():
    """Constant sign tables: the Hamilton product out_i = sum_jk
    QMUL[i, j, k] a_j b_k, the rotation matrix R_ij = [i == j] + sum_ab
    ROT[i, j, a, b] q_a q_b of a unit quaternion (`quat.py:to_matrix`'s
    entries, each one or two products), and skew(c)_ij = sum_k
    SKEW[i, j, k] c_k."""
    qmul = np.zeros((4, 4, 4), np.float32)
    for i, terms in enumerate((
            ((0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1)),
            ((0, 1, 1), (1, 0, 1), (2, 3, 1), (3, 2, -1)),
            ((0, 2, 1), (1, 3, -1), (2, 0, 1), (3, 1, 1)),
            ((0, 3, 1), (1, 2, 1), (2, 1, -1), (3, 0, 1)))):
        for j, k, sgn in terms:
            qmul[i, j, k] = sgn
    w, x, y, z = range(4)
    rot = np.zeros((3, 3, 4, 4), np.float32)
    for (i, j), terms in {
            (0, 0): ((y, y, -2), (z, z, -2)), (0, 1): ((x, y, 2), (w, z, -2)),
            (0, 2): ((x, z, 2), (w, y, 2)), (1, 0): ((x, y, 2), (w, z, 2)),
            (1, 1): ((x, x, -2), (z, z, -2)), (1, 2): ((y, z, 2), (w, x, -2)),
            (2, 0): ((x, z, 2), (w, y, -2)), (2, 1): ((y, z, 2), (w, x, 2)),
            (2, 2): ((x, x, -2), (y, y, -2))}.items():
        for a, b, c in terms:
            rot[i, j, a, b] = c
    skew = np.zeros((3, 3, 3), np.float32)
    for i, j, k, sgn in ((0, 1, 2, -1), (0, 2, 1, 1), (1, 0, 2, 1),
                         (1, 2, 0, -1), (2, 0, 1, -1), (2, 1, 0, 1)):
        skew[i, j, k] = sgn
    return qmul, rot, skew


def ancestor_dof_mask(m: Model) -> np.ndarray:
    """anc[d, e] = 1 for e <= d where dof e's body is an ancestor-or-self
    of dof d's (`ddiffpg_tpu/physics/engine.py:_structure`)."""
    nv = m.nv
    anc = np.zeros((nv, nv), np.float32)
    for d in range(nv):
        for e in range(d + 1):
            b = int(m.dof_body[d])
            while b >= 0 and b != int(m.dof_body[e]):
                b = int(m.parent[b])
            anc[d, e] = float(b >= 0)
    return anc


def probe_layout(m: Model):
    """(geom index, end sign) of every contact probe: sphere centres, then
    both end caps of each capsule, geoms in order."""
    gidx, ends = [], []
    for gi in range(m.ng):
        t = int(m.geom_type[gi])
        if t == SPHERE:
            gidx.append(gi)
            ends.append(0.0)
        elif t == CAPSULE:
            gidx += [gi, gi]
            ends += [1.0, -1.0]
    return np.array(gidx, np.int64), np.array(ends, np.float32)


def _members(seg_of):
    """The segments that have members; for each, its members in index
    order as a [n_seg, K] table padded with len(seg_of) (the pad column the
    caller appends); and each member's row in that table."""
    segs = sorted(set(int(s) for s in seg_of))
    rows = [[i for i, s in enumerate(seg_of) if int(s) == g] for g in segs]
    table = np.full((len(segs), max(len(r) for r in rows)), len(seg_of),
                    np.int64)
    for j, r in enumerate(rows):
        table[j, :len(r)] = r
    return (np.array(segs, np.int64), table,
            np.array([segs.index(int(s)) for s in seg_of], np.int64))


def _segment(x: torch.Tensor, table: torch.Tensor, pad: float, op: str):
    """x [B, n, ...] reduced along dim 1 over each row of `table` (pad
    entries read `pad`): a sum or an amax in a fixed order."""
    fill = x.new_full((x.shape[0], 1) + tuple(x.shape[2:]), pad)
    g = torch.cat([x, fill], 1)[:, table]            # [B, n_seg, K, ...]
    return g.sum(2) if op == "sum" else g.amax(2)


def _cross_motion(v, mv):
    w, vo = v[..., :3], v[..., 3:]
    mw, ml = mv[..., :3], mv[..., 3:]
    return torch.cat([torch.linalg.cross(w, mw),
                      torch.linalg.cross(w, ml) + torch.linalg.cross(vo, mw)],
                     -1)


def _cross_force(v, f):
    w, vo = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, n) + torch.linalg.cross(vo, fl),
                      torch.linalg.cross(w, fl)], -1)


def point_box_distance(p, bmin, bmax, normals):
    """Signed distance and outward normal of points p [..., 3] to boxes
    [bmin, bmax] (broadcastable [..., 3]); inside: minus the distance to the
    nearest face, the first in -x, -y, -z, +x, +y, +z order on ties, whose
    normals are the rows of `normals` [6, 3]."""
    clamped = torch.minimum(torch.maximum(p, bmin), bmax)
    delta = p - clamped
    d_out = torch.sqrt((delta * delta).sum(-1))
    outside = d_out > 1e-9
    n_out = delta / torch.where(outside, d_out, 1.0)[..., None]
    d_in, k = torch.cat([p - bmin, bmax - p], -1).min(-1)
    dist = torch.where(outside, d_out, -d_in)
    return dist, torch.where(outside[..., None], n_out, normals[k])


def chol_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for SPD M [B, n, n], b [B, n]
    (`ddiffpg_tpu/physics/engine.py:_chol_solve_envs_last`): the
    right-looking column Cholesky with the pivot clamped at 1e-9, the
    forward substitution carried along as an extra column (y_j = b_j / d_j,
    by the column's reciprocal), then the column-oriented backward
    substitution. Elementwise ops only: no host sync, no failure path.
    Row j of the work array ends as column j of L (M stays symmetric
    through the updates)."""
    n = M.shape[-1]
    A = torch.cat([M, b[..., None]], -1)                # [B, n, n + 1]
    for j in range(n):
        inv_d = torch.reciprocal(torch.sqrt(torch.clamp(A[:, j, j],
                                                        min=1e-9)))
        A[:, j, j:].mul_(inv_d[:, None])                # L[j:, j], y_j
        row = A[:, j, j + 1:]
        A[:, j + 1:, j + 1:].sub_(row[:, :n - j - 1, None] * row[:, None, :])
    x = A[:, :, n]
    for j in range(n - 1, -1, -1):
        x[:, j].div_(A[:, j, j])
        x[:, :j].sub_(A[:, :j, j] * x[:, j:j + 1])
    return x


class Engine:
    """`engine_cl` of one model on one device. `step(qpos [B, nq], qvel
    [B, nv], ctrl [B, nu])` -> (qpos, qvel) after the model's
    `n_substeps` substeps; float32 throughout."""

    def __init__(self, m: Model, device: str | torch.device = "cuda"):
        self.m = m
        self.device = dev = torch.device(device)
        self.kin = Kinematics(m, dev)
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.int64), device=dev)
        nb = m.nb
        qmul, rot, skew = _tables()
        self.QMUL, self.ROT, self.SKEW = f32(qmul), f32(rot), f32(skew)
        self.eye3 = torch.eye(3, device=dev)
        self.face_normals = torch.cat([-self.eye3, self.eye3])
        self.zhat = self.eye3[2]
        self.parent = [int(p) for p in m.parent]
        self.par = long([max(p, 0) for p in self.parent])
        self.is_root = torch.as_tensor([p < 0 for p in self.parent],
                                       device=dev)[:, None]
        # tree sums as masked contractions: SUB[i, j] = 1 for j in the
        # subtree of i (up the tree), its transpose down the tree, and the
        # dofs of each body's ancestors-or-self
        sub = self.kin.SUB.cpu().numpy()
        self.UP = f32(sub)[None, :, :, None]
        self.DOWN = f32(sub.T)[None, :, :, None]
        dof_body = np.asarray(m.dof_body)
        self.DOWN_DOF = f32(sub.T[:, dof_body])[None, :, :, None]
        self.OWN_DOF = f32(np.arange(nb)[:, None] == dof_body[None])[
            None, :, :, None]
        self.dt = float(m.dt)
        self.vreb = float(m.contact_maxrebound)
        self.vtol = float(m.friction_vel_tol)
        self.vmax = float(m.max_qvel)
        self.m_total = float(np.asarray(m.mass).sum())
        # a division by a constant is a product with its reciprocal, as the
        # card computes it anyway, so that the CPU and the card agree
        self.inv_dt, self.inv_vreb = 1.0 / self.dt, 1.0 / self.vreb
        self.inv_vtol, self.inv_m_total = 1.0 / self.vtol, 1.0 / self.m_total
        self.inv_nb = 1.0 / m.nb
        self.support = 2.0 * self.m_total * float(abs(m.gravity[2]))
        self.mass = f32(m.mass)
        self.com = f32(m.com)
        self.inertia = f32(m.inertia)
        self.a0 = f32(np.concatenate([np.zeros(3), -np.asarray(m.gravity)]))
        # FK: per level its index tensors and constants; roots keep their
        # constant frame, and identity body rotations are skipped (exact)
        self.fk_levels = []
        for lv, (jt, ids) in zip(self.kin.levels, _structure(m)[0]):
            if jt == FREE:
                self.fk_levels.append(lv)
                continue
            root = bool((m.parent[ids] < 0).all())
            if not root and (m.parent[ids] < 0).any():
                raise NotImplementedError("engine_cl: a level mixes roots "
                                          "and children")
            ident = np.allclose(np.asarray(m.body_quat)[ids], [1, 0, 0, 0],
                                atol=0, rtol=0)
            self.fk_levels.append(dict(
                lv, root=root, ident=ident,
                anchored=bool(np.abs(m.jnt_pos[ids]).max() > 0)))
        self.dof_body = long(m.dof_body)
        self.anc = f32(ancestor_dof_mask(m))
        self.armature = torch.diag(f32(m.dof_armature))
        self.damping = f32(m.dof_damping)
        self.lim_lo, self.lim_hi = f32(m.dof_limit_lo), f32(m.dof_limit_hi)
        self.lim_k = float(m.limit_stiffness)
        self.lim_c = float(m.limit_damping)
        one = np.where((m.jnt_type == HINGE) | (m.jnt_type == SLIDE))[0]
        self.one_qa = long(m.jnt_qposadr[one])
        self.one_da = long(m.jnt_dofadr[one])
        self.one_lo = f32(np.asarray(m.dof_limit_lo)[m.jnt_dofadr[one]])
        self.one_hi = f32(np.asarray(m.dof_limit_hi)[m.jnt_dofadr[one]])
        self.frees = [(i, int(m.jnt_qposadr[i]), int(m.jnt_dofadr[i]))
                      for i in range(nb) if m.jnt_type[i] == FREE]
        self.nu = int(m.nu)
        self.has_servo = bool((np.asarray(m.act_type) == 1).any())
        if self.nu:
            if len(set(int(d) for d in m.act_dof)) != self.nu:
                raise NotImplementedError("engine_cl: two actuators on one "
                                          "dof")
            self.act_dof = long(m.act_dof)
            self.is_servo = torch.as_tensor(np.asarray(m.act_type) == 1,
                                            device=dev)
            self.gear = f32(m.act_gear)
            self.kp, self.kd = f32(m.act_kp), f32(m.act_kd)
            self.act_lim = f32(m.act_force)
            self.act_qadr = long([m.jnt_qposadr[int(m.dof_body[d])]
                                  for d in m.act_dof])
        self._init_contacts(m, f32, long)
        self._graphs = {}

    def _init_contacts(self, m: Model, f32, long):
        gidx, ends = probe_layout(m)
        self.npts = len(gidx)
        if not self.npts:
            return
        body_of_pt = np.asarray(m.geom_body)[gidx]
        size = np.asarray(m.geom_size, np.float32)
        # a probe as one body-frame offset: the geom's position plus the
        # end cap along the geom's z axis
        gq = np.asarray(m.geom_quat, np.float64)[gidx]
        w, x, y, z = gq.T
        zax = np.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                        1 - 2 * (x * x + y * y)], -1)
        off = np.asarray(m.geom_pos, np.float64)[gidx] \
            + (ends * size[gidx, 1])[:, None] * zax
        self.probe_body = long(body_of_pt)
        self.probe_off = f32(off)
        self.rads = f32(size[gidx, 0])
        self.fric = f32(np.asarray(m.geom_friction)[gidx])
        m_eff = np.asarray(m.mass, np.float32)[body_of_pt]
        omega = 1.0 / float(m.contact_timeconst)
        self.m_eff = f32(m_eff)
        self.k_n = f32(m_eff * np.float32(omega ** 2))
        self.c_n = f32(np.float32(2.0 * float(m.contact_dampratio))
                       * m_eff * np.float32(omega))
        pt_bodies, table, row = _members(body_of_pt)
        self.pt_bodies, self.pt_table, self.pt_row = (
            long(pt_bodies), long(table), long(row))
        self.sdf = np.asarray(m.sdf_dist).size > 0
        if self.sdf:
            self.sdf_origin = tuple(float(o) for o in m.sdf_origin)
            self.inv_cell = 1.0 / float(m.sdf_cell)
            self.sdf_zmax = float(m.sdf_zmax)
            self.sdf_shape = tuple(int(s) for s in
                                   np.asarray(m.sdf_dist).shape)
            self.sdf_D = f32(m.sdf_dist).reshape(-1)
            self.sdf_G = f32(m.sdf_grad).reshape(-1, 2)
        self.nsb = int(m.nsb)
        if self.nsb:
            self.box_min = f32(m.static_box_min).reshape(-1, 3)
            self.box_max = f32(m.static_box_max).reshape(-1, 3)
        boxes = [gi for gi in range(m.ng) if int(m.geom_type[gi]) == BOX]
        self.nbox = len(boxes)
        if self.nbox:
            bb = np.asarray(m.geom_body)[boxes]
            self.box_body = long(bb)
            self.box_pos = f32(np.asarray(m.geom_pos)[boxes])
            self.box_quat = f32(np.asarray(m.geom_quat)[boxes])
            self.box_half = f32(size[boxes])
            # a box does not touch its own body's probes
            self.box_keep = torch.as_tensor(
                bb[:, None] != body_of_pt[None], device=self.device)
            bodies, table, _ = _members(bb)
            self.box_bodies, self.box_table = long(bodies), long(table)

    # ------------------------------------------------------------ quaternions

    def qmul(self, a, b):
        """The Hamilton product of [..., 4] quaternions, one contraction."""
        return ((a[..., None, :, None] * b[..., None, None, :])
                * self.QMUL).sum((-1, -2))

    def to_matrix(self, q):
        """Rotation matrices [..., 3, 3] of unit quaternions [..., 4]."""
        qq = q[..., :, None] * q[..., None, :]
        return self.eye3 + (qq[..., None, None, :, :] * self.ROT).sum(
            (-1, -2))

    # ------------------------------------------------------------ kinematics

    def fk(self, qpos):
        """World positions [B, nb, 3] and quaternions [B, nb, 4], one
        batched step per (depth, joint type) level of `Kinematics`."""
        B, nb = qpos.shape[0], self.m.nb
        pos = qpos.new_zeros((B, nb, 3))
        quat = qpos.new_zeros((B, nb, 4))
        quat[..., 0] = 1.0
        for lv in self.fk_levels:
            jt, ids, qa = lv["jt"], lv["ids"], lv["qa"]
            if jt == FREE:
                vals = qpos[:, lv["qa7"]]
                pos[:, ids] = vals[..., :3]
                quat[:, ids] = vals[..., 3:7]
                continue
            if lv["root"]:
                p0 = lv["body_pos"].expand(B, -1, -1)
                q0 = lv["body_quat"].expand(B, -1, -1)
            else:
                pq = quat[:, lv["par"]]
                p0 = pos[:, lv["par"]] + Q.rotate(pq, lv["body_pos"])
                q0 = pq if lv["ident"] else self.qmul(pq, lv["body_quat"])
            if jt == HINGE:
                half = qpos[:, qa] * 0.5
                qj = torch.cat([torch.cos(half)[..., None],
                                lv["axis"] * torch.sin(half)[..., None]], -1)
                qn = self.qmul(q0, qj)
                pn = p0
                if lv["anchored"]:
                    pn = p0 + Q.rotate(q0, lv["anchor"]) \
                        - Q.rotate(qn, lv["anchor"])
            elif jt == SLIDE:
                qn = q0
                pn = p0 + Q.rotate(q0, lv["axis"]) * qpos[:, qa][..., None]
            else:   # FIXED
                qn, pn = q0, p0
            pos[:, ids] = pn
            quat[:, ids] = qn
        return pos, quat

    def joint_velocities(self, S, u):
        """vJ [B, nb, 6]: S qdot summed over each body's dofs."""
        return ((S * u[..., None])[:, None] * self.OWN_DOF).sum(2)

    def down_tree(self, x):
        """out[i] = the sum of x [B, nb, k] over the ancestors-or-self of
        i."""
        return (x[:, None] * self.DOWN).sum(2)

    def up_tree(self, x):
        """out[i] = the sum of x [B, nb, k] over the subtree of i."""
        return (x[:, None] * self.UP).sum(2)

    def body_velocities(self, S, u):
        """V [B, nb, 6]: S qdot summed over the dofs of each body's
        ancestors-or-self."""
        return ((S * u[..., None])[:, None] * self.DOWN_DOF).sum(2)

    def u_to_qvel(self, u, body_pos):
        qvel = u.clone()
        for i, _, d in self.frees:
            qvel[:, d: d + 3] = u[:, d: d + 3] + torch.linalg.cross(
                u[:, d + 3: d + 6], body_pos[:, i])
        return qvel

    # -------------------------------------------------------------- dynamics

    def spatial_inertia(self, body_pos, body_quat):
        """6x6 spatial inertias [B, nb, 6, 6] about the frame origin."""
        R = self.to_matrix(body_quat)                       # [B, nb, 3, 3]
        c = body_pos + (R * self.com[:, None, :]).sum(-1)
        RI = (R[..., :, :, None] * self.inertia[:, None]).sum(-2)
        Ic = (RI[..., :, None, :] * R[..., None, :, :]).sum(-1)
        mass = self.mass[:, None, None]
        cx = (c[..., None, None, :] * self.SKEW).sum(-1)
        cxcx = (cx[..., :, :, None] * cx[..., None, :, :]).sum(-2)
        tr = mass * cx
        return torch.cat([torch.cat([Ic - mass * cxcx, tr], -1),
                          torch.cat([-tr, (mass * self.eye3).expand_as(tr)],
                                    -1)], -2)

    def crba(self, I6, S):
        """The joint-space mass matrix [B, nv, nv] from composite
        inertias, its lower triangle mirrored, plus the armature."""
        B, nb = I6.shape[:2]
        Ic = self.up_tree(I6.reshape(B, nb, 36)).reshape(B, nb, 6, 6)
        F = (Ic[:, self.dof_body] * S[:, :, None, :]).sum(-1)   # [B, nv, 6]
        Mv = (F[:, :, None, :] * S[:, None, :, :]).sum(-1) * self.anc
        M = Mv + Mv.transpose(1, 2) - torch.diag_embed(
            torch.diagonal(Mv, dim1=1, dim2=2))
        return M + self.armature

    def bias_forces(self, I6, S, V, u, f_ext):
        """RNEA at zero joint acceleration: the bias torques [B, nv]."""
        Vp = torch.where(self.is_root, 0.0, V[:, self.par])
        A = self.a0 + self.down_tree(
            _cross_motion(Vp, self.joint_velocities(S, u)))
        IA = (I6 * A[:, :, None, :]).sum(-1)
        IV = (I6 * V[:, :, None, :]).sum(-1)
        f = IA + _cross_force(V, IV) - f_ext
        return (S * self.up_tree(f)[:, self.dof_body]).sum(-1)

    def gravity_torques(self, I6, S):
        """`bias_forces` at zero velocity and no contact (the servos'
        gravity compensation), its zero terms left out: bitwise alike."""
        f = (I6 * self.a0).sum(-1)
        return (S * self.up_tree(f)[:, self.dof_body]).sum(-1)

    def passive_torques(self, qpos, u):
        """Joint damping and the limits' spring-dampers [B, nv]."""
        qd = torch.zeros_like(u)
        qd[:, self.one_da] = qpos[:, self.one_qa]
        over = torch.clamp(qd - self.lim_hi, min=0.0)
        under = torch.clamp(self.lim_lo - qd, min=0.0)
        active = (over > 0) | (under > 0)
        tau = -self.damping * u - self.lim_k * (over - under)
        return tau - torch.where(active, self.lim_c * u, 0.0)

    def actuator_torques(self, ctrl, qpos, u, tau_grav=None):
        """Torque motors (gear * clip(ctrl, -1, 1)) and force-limited PD
        servos with the gravity compensation `tau_grav` inside the limit
        (`engine_cl.py:actuator_torques`) -> [B, nv]."""
        tau = u.new_zeros(u.shape)
        if not self.nu:
            return tau
        f = self.gear * torch.clamp(ctrl, -1.0, 1.0)
        if self.has_servo:
            f_servo = self.kp * (ctrl - qpos[:, self.act_qadr]) \
                - self.kd * u[:, self.act_dof]
            if tau_grav is not None:
                f_servo = f_servo + tau_grav[:, self.act_dof]
            f_servo = torch.minimum(torch.maximum(f_servo, -self.act_lim),
                                    self.act_lim)
            f = torch.where(self.is_servo, f_servo, f)
        tau[:, self.act_dof] = f
        return tau

    # -------------------------------------------------------------- contacts

    def probe_points(self, body_pos, body_quat):
        """World probe points [B, npts, 3]."""
        pb = self.probe_body
        return body_pos[:, pb] + Q.rotate(body_quat[:, pb], self.probe_off)

    def _normal_force(self, pen, v_n, m_eff, k_n, c_n):
        """The penalty normal force of probes at penetration `pen` and
        normal velocity v_n."""
        f_n = torch.clamp(k_n * pen - c_n * v_n, min=0.0)
        f_n = torch.where(pen > 0, f_n, 0.0)
        # separation gate: strictly dissipative impacts (types.py)
        f_n = f_n * torch.clamp(1.0 - v_n * self.inv_vreb, 0.0, 1.0)
        # impulse cap: the post-substep rebound stays <= maxrebound
        return torch.minimum(f_n, torch.clamp(
            m_eff * (self.vreb - v_n) * self.inv_dt, min=0.0))

    def _contact(self, n, pen, v_pt, v_bl, probe_axes=0):
        """Contacts of normal n [..., 3] at penetration `pen`: their force,
        normal force and their body's normal velocity (+inf out of
        contact, for the budget). `probe_axes` axes follow the probe axis
        of the probe constants."""
        at = (slice(None),) + (None,) * probe_axes
        v_n = (v_pt * n).sum(-1)
        f_n = self._normal_force(pen, v_n, self.m_eff[at], self.k_n[at],
                                 self.c_n[at])
        v_t = v_pt - v_n[..., None] * n
        vt_norm = torch.sqrt((v_t * v_t).sum(-1) + self.vtol ** 2 * 1e-4)
        scale = torch.clamp(vt_norm * self.inv_vtol, max=1.0)
        f_t = -self.fric[at] * f_n * scale / vt_norm
        return (f_n[..., None] * n + f_t[..., None] * v_t, f_n,
                torch.where(pen > 0, (v_bl * n).sum(-1), INF))

    def contact_forces(self, body_pos, body_quat, V, p0=None, diag=None):
        """Per-body spatial contact forces [B, nb, 6] ([n_o; f] about p0
        [B, 3], the zero vector by default). Geometry is absolute; the
        velocity and torque arms are taken about p0. `diag`, a dict when
        given, receives the probe points and each branch's penetrations
        and normal forces, and the budgets' scales."""
        B = body_pos.shape[0]
        if p0 is None:
            p0 = body_pos.new_zeros((B, 3))
        F = body_pos.new_zeros((B, self.m.nb, 6))
        if not self.npts:
            return F
        pts = self.probe_points(body_pos, body_quat)
        pts_r = pts - p0[:, None]
        bp_r = body_pos - p0[:, None]
        Vp = V[:, self.probe_body]                          # [B, npts, 6]
        v_pt = Vp[..., 3:] + torch.linalg.cross(Vp[..., :3], pts_r)
        # the impulse budget meters each body's (~COM) motion
        v_bl = (V[..., 3:] + torch.linalg.cross(V[..., :3], bp_r))[
            :, self.probe_body]

        # the world, one batch [B, npts, C] of contacts: the plane z = 0,
        # then the SDF walls (C = 2) or every wall box (C = 1 + nsb)
        normals = [self.zhat.expand(pts.shape)[:, :, None]]
        pens = [torch.clamp(self.rads - pts[..., 2], min=0.0)[..., None]]
        if self.sdf:
            n_s, pen_s = self._sdf_walls(pts)
            normals.append(n_s[:, :, None])
            pens.append(pen_s[..., None])
        elif self.nsb:
            d_b, n_b = point_box_distance(pts[:, :, None], self.box_min,
                                          self.box_max, self.face_normals)
            normals.append(n_b)
            pens.append(torch.clamp(self.rads[:, None] - d_b, min=0.0))
        pen = torch.cat(pens, -1)
        f, f_n, v_cn = self._contact(torch.cat(normals, 2), pen,
                                     v_pt[:, :, None], v_bl[:, :, None],
                                     probe_axes=1)
        total, imp_pt, vmin_pt = f.sum(2), f_n.sum(2), v_cn.amin(2)
        if diag is not None:
            diag.update(pts=pts, pen_floor=pen[..., 0], fn_floor=f_n[..., 0],
                        pen_wall=pen[..., 1:], fn_wall=f_n[..., 1:])

        # per-body world-contact impulse budget: a static-support allowance
        # fading as the body separates, plus a rebound allowance
        fade = torch.clamp(1.0 - vmin_pt * self.inv_vreb, 0.0, 1.0)
        allow = self.support * fade + self.m_eff * torch.clamp(
            self.vreb - vmin_pt, min=0.0) * self.inv_dt
        imp_body = _segment(imp_pt, self.pt_table, 0.0, "sum")
        s_body = torch.clamp(
            _segment(allow, self.pt_table, -INF, "amax")
            / torch.clamp(imp_body, min=1e-9), max=1.0)
        total = total * s_body[:, self.pt_row][..., None]

        # global vertical-thrust budget against the COM vertical velocity
        w, vo = V[..., :3], V[..., 3:]
        vcom_z = vo[..., 2] + (w[..., 0] * bp_r[..., 1]
                               - w[..., 1] * bp_r[..., 0])
        vz_com = (self.mass * vcom_z).sum(-1) * self.inv_m_total
        allow_up = self.support * torch.clamp(
            1.0 - vz_com * self.inv_vreb, 0.0, 1.0) + self.m_total * torch.clamp(
            self.vreb - vz_com, min=0.0) * self.inv_dt
        fz = total[..., 2]
        f_up = torch.clamp(fz, min=0.0).sum(-1)
        s_up = torch.clamp(allow_up / torch.clamp(f_up, min=1e-9), max=1.0)
        total = torch.cat([total[..., :2], torch.where(
            fz > 0, fz * s_up[:, None], fz)[..., None]], -1)
        if diag is not None:     # the scales of bodies in contact
            diag.update(s_body=torch.where(imp_body > 0, s_body, 1.0),
                        s_up=torch.where(f_up > 0, s_up, 1.0))

        if self.nbox:
            total = total + self._dynamic_boxes(F, body_pos, body_quat, V,
                                                pts, pts_r, v_pt, diag)
        F_pt = _segment(torch.cat([torch.linalg.cross(pts_r, total), total],
                                  -1), self.pt_table, 0.0, "sum")
        F[:, self.pt_bodies] = F[:, self.pt_bodies] + F_pt
        return F

    def _sdf_walls(self, pts):
        """Normals and penetrations of the probes in the walls: a bilinear
        lookup of the 2-D SDF and its gradient."""
        ox, oy = self.sdf_origin
        nx, ny = self.sdf_shape
        gx = torch.clamp((pts[..., 0] - ox) * self.inv_cell, 0.0, nx - 1.001)
        gy = torch.clamp((pts[..., 1] - oy) * self.inv_cell, 0.0, ny - 1.001)
        ix, iy = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - ix, gy - iy
        # a NaN probe (a broken state) must not index out of the grid
        base = ix.long().clamp(0, nx - 2) * ny + iy.long().clamp(0, ny - 2)
        idx = torch.stack([base, base + ny, base + 1, base + ny + 1], -1)
        w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                         (1 - fx) * fy, fx * fy], -1)      # [B, npts, 4]
        d_s = (self.sdf_D[idx] * w).sum(-1) - self.rads
        n2 = (self.sdf_G[idx] * w[..., None]).sum(-2)      # [B, npts, 2]
        n2 = n2 / torch.clamp(torch.sqrt((n2 * n2).sum(-1, keepdim=True)),
                              min=1e-6)
        n_s = torch.cat([n2, torch.zeros_like(n2[..., :1])], -1)
        # only contacts below the wall top
        d_s = torch.where(pts[..., 2] < self.sdf_zmax, d_s, 1e9)
        return n_s, torch.clamp(-d_s, min=0.0)

    def _dynamic_boxes(self, F, body_pos, body_quat, V, pts, pts_r, v_pt,
                       diag):
        """Contacts of the probes with the body-attached OBBs (drawers,
        doors), all boxes at once: returns their forces on the probes
        [B, npts, 3] and subtracts the reactions from the boxes' bodies'
        rows of F."""
        bb = self.box_body
        bq = self.qmul(body_quat[:, bb], self.box_quat)      # [B, nbox, 4]
        bpos = body_pos[:, bb] + Q.rotate(body_quat[:, bb], self.box_pos)
        conj = torch.cat([bq[..., :1], -bq[..., 1:]], -1)
        local = Q.rotate(conj[:, :, None], pts[:, None] - bpos[:, :, None])
        half = self.box_half[:, None]                       # [nbox, 1, 3]
        d, n_loc = point_box_distance(local, -half, half, self.face_normals)
        n_w = Q.rotate(bq[:, :, None], n_loc)               # [B, nbox, npts]
        pen = torch.where(self.box_keep, torch.clamp(self.rads - d, min=0.0),
                          0.0)
        Vb = V[:, bb, None]                                 # [B, nbox, 1, 6]
        v_rel = v_pt[:, None] - (Vb[..., 3:] + torch.linalg.cross(
            Vb[..., :3].expand(-1, -1, self.npts, -1),
            pts_r[:, None].expand(-1, self.nbox, -1, -1)))
        f_vec, _, _ = self._contact(n_w, pen, v_rel, v_rel)
        react = torch.cat([torch.linalg.cross(
            pts_r[:, None].expand_as(f_vec), f_vec).sum(2), f_vec.sum(2)], -1)
        F[:, self.box_bodies] = F[:, self.box_bodies] - _segment(
            react, self.box_table, 0.0, "sum")
        if diag is not None:
            diag["pen_box"] = pen
        return f_vec.sum(1)

    # ------------------------------------------------------------ integrator

    def substep(self, qpos, qvel, ctrl):
        kin = self.kin
        body_pos, body_quat = self.fk(qpos)
        # spatial algebra in the robot-centred frame (f32 at the world
        # origin injects momentum far from it; engine.py:_substep)
        p0 = body_pos.sum(1) * self.inv_nb
        bp = body_pos - p0[:, None]
        S = kin.dof_subspaces(bp, body_quat)
        u = kin.qvel_to_u(qvel, bp)
        V = self.body_velocities(S, u)
        I6 = self.spatial_inertia(bp, body_quat)
        f_ext = self.contact_forces(body_pos, body_quat, V, p0)
        tau = self.actuator_torques(
            ctrl, qpos, u, self.gravity_torques(I6, S)
            if self.has_servo else None) \
            + self.passive_torques(qpos, u) \
            - self.bias_forces(I6, S, V, u, f_ext)
        udot = chol_solve(self.crba(I6, S), tau)

        vmax, dt = self.vmax, self.dt
        u_new = torch.clamp(u + dt * udot, -vmax, vmax)
        # the physical-velocity clamp still guards w x (pos - p0)
        qvel_new = torch.clamp(self.u_to_qvel(u_new, bp), -vmax, vmax)
        qpos_new = qpos.clone()
        if len(self.one_qa):
            qa, da = self.one_qa, self.one_da
            qv = qpos[:, qa] + dt * qvel_new[:, da]
            qd = qvel_new[:, da]
            # inelastic limit stops: projection, outward velocity zeroed
            qd = torch.where(qv < self.one_lo, torch.clamp(qd, min=0.0), qd)
            qd = torch.where(qv > self.one_hi, torch.clamp(qd, max=0.0), qd)
            qpos_new[:, qa] = torch.minimum(torch.maximum(qv, self.one_lo),
                                            self.one_hi)
            qvel_new[:, da] = qd
        for _, qa, d in self.frees:
            qpos_new[:, qa: qa + 3] = qpos[:, qa: qa + 3] \
                + dt * qvel_new[:, d: d + 3]
            w = qvel_new[:, d + 3: d + 6]
            angle = torch.sqrt((w * w).sum(-1, keepdim=True))
            axis = w / torch.where(angle > 1e-9, angle, 1.0)
            half = angle * dt * 0.5
            qn = self.qmul(torch.cat([torch.cos(half),
                                      axis * torch.sin(half)], -1),
                           qpos[:, qa + 3: qa + 7])
            qpos_new[:, qa + 3: qa + 7] = qn / torch.sqrt(
                (qn * qn).sum(-1, keepdim=True))
        return qpos_new, qvel_new

    def _check(self, qpos, qvel, ctrl):
        m = self.m
        for name, t, w in (("qpos", qpos, m.nq), ("qvel", qvel, m.nv),
                           ("ctrl", ctrl, m.nu)):
            if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != w:
                raise ValueError(f"{name}: want float32 [B, {w}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device.type != self.device.type or (
                    self.device.index is not None
                    and t.device.index != self.device.index):
                raise ValueError(f"{name} on {t.device}, engine on "
                                 f"{self.device}")

    @torch.no_grad()
    def step(self, qpos, qvel, ctrl):
        """One control step: `n_substeps` substeps at a fixed ctrl."""
        self._check(qpos, qvel, ctrl)
        for _ in range(int(self.m.n_substeps)):
            qpos, qvel = self.substep(qpos, qvel, ctrl)
        return qpos, qvel

    @torch.no_grad()
    def graphed_step(self, qpos, qvel, ctrl):
        """`step` through a CUDA graph of this batch size, captured on its
        first call (on the CPU, `step`): the same kernels on the same
        inputs, so bitwise the eager step."""
        if self.device.type != "cuda":
            return self.step(qpos, qvel, ctrl)
        self._check(qpos, qvel, ctrl)
        B = qpos.shape[0]
        if B not in self._graphs:
            self._graphs[B] = self._capture(qpos, qvel, ctrl)
        graph, ins, outs = self._graphs[B]
        for dst, src in zip(ins, (qpos, qvel, ctrl)):
            dst.copy_(src)
        graph.replay()
        return outs[0].clone(), outs[1].clone()

    def _capture(self, qpos, qvel, ctrl):
        ins = tuple(t.clone() for t in (qpos, qvel, ctrl))
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):       # warm-up before the capture
                self.step(*ins)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self.step(*ins)
        return graph, ins, outs


def step(m: Model, qpos, qvel, ctrl):
    """`Engine.step` of a model met once (its tensors built for the call)."""
    return Engine(m, qpos.device).step(qpos, qvel, ctrl)
