"""Kinematics of the articulated engine, batched over a leading `[B]`.

Counterpart of the kinematic half of `ddiffpg_tpu/physics/engine.py`:
`_structure`, `fk`, `dof_subspaces`, `qvel_to_u`, `_joint_vel` and
`body_velocities`, in world-origin coordinates as there. `Kinematics`
holds a model's structure and its index and constant tensors on a device
(the card unless told otherwise), built once; the Panda env's observation
(end-effector position and velocity), its `ee` control's IK and the
batched engine `physics/engine_cl.py` (the dynamics) are built on one.
The per-env engine's own dynamics are not ported a second time.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.physics import quat as Q
from benchmark.reference.physics.types import FIXED, FREE, HINGE, SLIDE, Model


def _structure(m: Model):
    """Static tree structure (numpy): the (joint type, body ids) levels in
    depth order, and the subtree mask SUB[i, j] (j in the subtree of i,
    self included)."""
    nb = m.nb
    depth = np.zeros(nb, int)
    for i in range(nb):
        p = int(m.parent[i])
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = []
    for d in range(int(depth.max()) + 1):
        for jt in (FREE, HINGE, SLIDE, FIXED):
            ids = np.where((depth == d) & (m.jnt_type == jt))[0]
            if len(ids):
                levels.append((jt, ids))
    SUB = np.zeros((nb, nb), np.float32)
    for j in range(nb):
        i = j
        while i >= 0:
            SUB[i, j] = 1.0
            i = int(m.parent[i])
    return levels, SUB


class Kinematics:
    """The kinematics of one model on one device: `_structure`'s levels and
    subtree mask, and every index and constant tensor that FK, the motion
    subspaces and the body velocities read, built once. An env holds one
    (a Panda control step with `ee` control runs FK four times); the
    module's functions below build one a call. Outputs are bitwise those of
    the per-call functions: the same ops on the same values."""

    def __init__(self, m: Model, device: str | torch.device = "cuda"):
        self.m = m
        self.device = dev = torch.device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def long(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        levels, SUB = _structure(m)
        self.ident = f32([1.0, 0.0, 0.0, 0.0])
        self.levels = []
        for jt, ids in levels:
            lv = {"jt": jt, "ids": long(ids),
                  "qa": long(m.jnt_qposadr[ids])}
            if jt == FREE:
                lv["qa7"] = lv["qa"][:, None] + torch.arange(7, device=dev)
            else:
                lv["par"] = long(np.maximum(m.parent[ids], 0))
                lv["is_root"] = torch.as_tensor(m.parent[ids] < 0,
                                                device=dev)[:, None]
                lv["body_pos"] = f32(m.body_pos[ids])
                lv["body_quat"] = f32(m.body_quat[ids])
                lv["axis"] = f32(m.jnt_axis[ids])
                lv["anchor"] = f32(m.jnt_pos[ids])
            self.levels.append(lv)
        self.SUB = f32(SUB)
        base = np.zeros((m.nv, 6), np.float32)
        self.free = []
        for i in range(m.nb):
            if m.jnt_type[i] == FREE:
                d = int(m.jnt_dofadr[i])
                base[d: d + 3, 3:] = np.eye(3)
                base[d + 3: d + 6, :3] = np.eye(3)
                self.free.append((i, d))
        self.S_base = f32(base)
        hinge = np.where(m.jnt_type == HINGE)[0]
        slide = np.where(m.jnt_type == SLIDE)[0]
        self.hinge = (long(hinge), long(m.jnt_dofadr[hinge]),
                      f32(m.jnt_axis[hinge]), f32(m.jnt_pos[hinge])) \
            if len(hinge) else None
        self.slide = (long(slide), long(m.jnt_dofadr[slide]),
                      f32(m.jnt_axis[slide])) if len(slide) else None
        self.dof_body = long(m.dof_body)

    def fk(self, qpos: torch.Tensor):
        """Forward kinematics of qpos [B, nq]: world positions [B, nb, 3]
        and quaternions [B, nb, 4], one batched op per (depth, joint type)
        level."""
        m = self.m
        B = qpos.shape[0]
        pos = qpos.new_zeros((B, m.nb, 3))
        quat = qpos.new_zeros((B, m.nb, 4))
        quat[..., 0] = 1.0
        for lv in self.levels:
            jt, ids, qa = lv["jt"], lv["ids"], lv["qa"]
            if jt == FREE:
                vals = qpos[:, lv["qa7"]]
                pos[:, ids] = vals[..., :3]
                quat[:, ids] = vals[..., 3:7]
                continue
            par, is_root = lv["par"], lv["is_root"]
            pp = torch.where(is_root, 0.0, pos[:, par])
            pq = torch.where(is_root, self.ident, quat[:, par])
            p0 = pp + Q.rotate(pq, lv["body_pos"])
            q0 = Q.mul(pq, lv["body_quat"])
            if jt == HINGE:
                qj = Q.from_axis_angle(lv["axis"], qpos[:, qa])
                qn = Q.mul(q0, qj)
                anchor = lv["anchor"]
                pn = p0 + Q.rotate(q0, anchor) - Q.rotate(qn, anchor)
            elif jt == SLIDE:
                qn = q0
                pn = p0 + Q.rotate(q0, lv["axis"]) * qpos[:, qa][..., None]
            else:   # FIXED
                qn, pn = q0, p0
            pos[:, ids] = pn
            quat[:, ids] = qn
        return pos, quat

    def dof_subspaces(self, body_pos: torch.Tensor,
                      body_quat: torch.Tensor):
        """Motion subspaces S [B, nv, 6] in world-origin coordinates."""
        S = self.S_base.expand(body_pos.shape[0], -1, -1).clone()
        if self.hinge is not None:
            ids, dof, axis, anchor = self.hinge
            bq = body_quat[:, ids]
            w = Q.rotate(bq, axis)
            a = body_pos[:, ids] + Q.rotate(bq, anchor)
            S[:, dof] = torch.cat([w, torch.linalg.cross(a, w)], dim=-1)
        if self.slide is not None:
            ids, dof, axis = self.slide
            w = Q.rotate(body_quat[:, ids], axis)
            S[:, dof] = torch.cat([torch.zeros_like(w), w], dim=-1)
        return S

    def qvel_to_u(self, qvel: torch.Tensor, body_pos: torch.Tensor):
        """(v_p, omega) -> internal (v_origin, omega) for free joints."""
        u = qvel.clone()
        for i, d in self.free:
            vp, w = qvel[:, d: d + 3], qvel[:, d + 3: d + 6]
            u[:, d: d + 3] = vp - torch.linalg.cross(w, body_pos[:, i])
        return u

    def body_velocities(self, S: torch.Tensor, u: torch.Tensor):
        """V [B, nb, 6]: the per-body joint velocity vJ (S qdot summed over
        each body's dofs) summed over ancestors-or-self, one masked
        matmul."""
        vJ = S.new_zeros((S.shape[0], self.m.nb, 6)).index_add_(
            1, self.dof_body, S * u[..., None])
        return torch.einsum("ji,bjk->bik", self.SUB, vJ)


def fk(m: Model, qpos: torch.Tensor):
    """`Kinematics.fk` of a model met once."""
    return Kinematics(m, qpos.device).fk(qpos)


def dof_subspaces(m: Model, body_pos: torch.Tensor, body_quat: torch.Tensor):
    """`Kinematics.dof_subspaces` of a model met once."""
    return Kinematics(m, body_pos.device).dof_subspaces(body_pos, body_quat)


def qvel_to_u(m: Model, qvel: torch.Tensor, body_pos: torch.Tensor):
    """`Kinematics.qvel_to_u` of a model met once."""
    return Kinematics(m, qvel.device).qvel_to_u(qvel, body_pos)


def body_velocities(m: Model, S: torch.Tensor, u: torch.Tensor):
    """`Kinematics.body_velocities` of a model met once."""
    return Kinematics(m, S.device).body_velocities(S, u)
