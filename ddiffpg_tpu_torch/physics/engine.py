"""Kinematics of the articulated engine, batched over a leading `[B]`.

Counterpart of the kinematic half of `ddiffpg_tpu/physics/engine.py`:
`_structure`, `fk`, `dof_subspaces`, `qvel_to_u`, `_joint_vel` and
`body_velocities`, in world-origin coordinates as there. The Panda env's
observation (end-effector position and velocity) is built from them. The
dynamics of that engine (`crba`, `bias_forces`, `contact_forces`, `step`)
are not ported: the substep kernel and its plain version
(`physics/substep.py`) are the port's physics.
"""

from __future__ import annotations

import numpy as np
import torch

from ddiffpg_tpu_torch.physics import quat as Q
from ddiffpg_tpu_torch.physics.types import FIXED, FREE, HINGE, SLIDE, Model


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


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def fk(m: Model, qpos: torch.Tensor):
    """Forward kinematics of qpos [B, nq]: world positions [B, nb, 3] and
    quaternions [B, nb, 4], one batched op per (depth, joint type) level."""
    levels, _ = _structure(m)
    B = qpos.shape[0]
    pos = qpos.new_zeros((B, m.nb, 3))
    quat = qpos.new_zeros((B, m.nb, 4))
    quat[..., 0] = 1.0
    ident = _const([1.0, 0.0, 0.0, 0.0], qpos)
    for jt, ids in levels:
        qa = torch.as_tensor(m.jnt_qposadr[ids], device=qpos.device)
        if jt == FREE:
            vals = qpos[:, qa[:, None] + torch.arange(7, device=qpos.device)]
            pos[:, ids] = vals[..., :3]
            quat[:, ids] = vals[..., 3:7]
            continue
        par = np.maximum(m.parent[ids], 0)
        is_root = torch.as_tensor(m.parent[ids] < 0,
                                  device=qpos.device)[:, None]
        pp = torch.where(is_root, 0.0, pos[:, par])
        pq = torch.where(is_root, ident, quat[:, par])
        p0 = pp + Q.rotate(pq, _const(m.body_pos[ids], qpos))
        q0 = Q.mul(pq, _const(m.body_quat[ids], qpos))
        if jt == HINGE:
            qj = Q.from_axis_angle(_const(m.jnt_axis[ids], qpos), qpos[:, qa])
            qn = Q.mul(q0, qj)
            anchor = _const(m.jnt_pos[ids], qpos)
            pn = p0 + Q.rotate(q0, anchor) - Q.rotate(qn, anchor)
        elif jt == SLIDE:
            qn = q0
            pn = p0 + Q.rotate(q0, _const(m.jnt_axis[ids], qpos)) \
                * qpos[:, qa][..., None]
        else:   # FIXED
            qn, pn = q0, p0
        pos[:, ids] = pn
        quat[:, ids] = qn
    return pos, quat


def dof_subspaces(m: Model, body_pos: torch.Tensor, body_quat: torch.Tensor):
    """Motion subspaces S [B, nv, 6] in world-origin coordinates."""
    base = np.zeros((m.nv, 6), np.float32)
    for i in range(m.nb):
        if m.jnt_type[i] == FREE:
            d = int(m.jnt_dofadr[i])
            base[d: d + 3, 3:] = np.eye(3)
            base[d + 3: d + 6, :3] = np.eye(3)
    S = _const(base, body_pos).expand(body_pos.shape[0], -1, -1).clone()
    hinge = np.where(m.jnt_type == HINGE)[0]
    if len(hinge):
        bq = body_quat[:, hinge]
        w = Q.rotate(bq, _const(m.jnt_axis[hinge], bq))
        a = body_pos[:, hinge] + Q.rotate(bq, _const(m.jnt_pos[hinge], bq))
        S[:, m.jnt_dofadr[hinge]] = torch.cat(
            [w, torch.linalg.cross(a, w)], dim=-1)
    slide = np.where(m.jnt_type == SLIDE)[0]
    if len(slide):
        w = Q.rotate(body_quat[:, slide], _const(m.jnt_axis[slide], body_quat))
        S[:, m.jnt_dofadr[slide]] = torch.cat([torch.zeros_like(w), w], dim=-1)
    return S


def qvel_to_u(m: Model, qvel: torch.Tensor, body_pos: torch.Tensor):
    """(v_p, omega) -> internal (v_origin, omega) for free joints."""
    u = qvel.clone()
    for i in range(m.nb):
        if m.jnt_type[i] == FREE:
            d = int(m.jnt_dofadr[i])
            vp, w = qvel[:, d: d + 3], qvel[:, d + 3: d + 6]
            u[:, d: d + 3] = vp - torch.linalg.cross(w, body_pos[:, i])
    return u


def _joint_vel(m: Model, S: torch.Tensor, u: torch.Tensor):
    """Per-body joint velocity vJ [B, nb, 6]: S qdot summed over each
    body's dofs."""
    idx = torch.as_tensor(m.dof_body, device=S.device)
    return S.new_zeros((S.shape[0], m.nb, 6)).index_add_(
        1, idx, S * u[..., None])


def body_velocities(m: Model, S: torch.Tensor, u: torch.Tensor):
    """V [B, nb, 6]: vJ summed over ancestors-or-self, one masked matmul."""
    _, SUB = _structure(m)
    return torch.einsum("ji,bjk->bik", _const(SUB, S), _joint_vel(m, S, u))
