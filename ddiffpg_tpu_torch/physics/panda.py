"""7-DoF Franka Panda arm + task furniture (numpy scene builder).

Counterpart of `ddiffpg_tpu/physics/panda.py`: the Franka joint frames and
limits, the arm with its PD position servos (the engine's equivalent of
PyBullet's POSITION_CONTROL with joint forces), and the four task scenes.
Scene layout as there: robot base at (-0.6, 0, 0), the table top is the
z = 0 plane, task furniture is static AABBs plus 1-dof dynamic boxes
(drawer slides, cabinet door). The builder gives `Model`s field-identical
to the JAX package's. `Arm` holds one scene's kinematics on a device for
the env's observation and its `ee` control (`ee_point`, `ee_jacobian`,
`dls_ik`). Handed the env's CUDA substep kernel (`Arm.kernel`, set by
`envs/panda.py:PandaTaskEnv` wherever the env steps through it), `Arm`
alone picks the route: `ee_state` takes one launch of the kernel's
ee-state entry, and `ee_point` and `dls_ik` one launch each of its IK entry
(`dls_ik_kernel` in `csrc/substep.cu`), which computes what the plain
PyTorch below computes on the card bit for bit; without it (the CPU,
`use_pallas=False`) all three run that plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ddiffpg_tpu_torch.physics import engine
from ddiffpg_tpu_torch.physics import quat as Q
from ddiffpg_tpu_torch.physics import types as T
from ddiffpg_tpu_torch.physics.builder import BodySpec, GeomSpec, JointSpec, build

PI = np.pi

# Franka joint frames (xyz, rpy) in the parent link frame; all axes are the
# local +z (values from the standard franka_panda URDF used by panda-gym)
PANDA_JOINTS = [
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (-PI / 2, 0.0, 0.0)),
    ((0.0, -0.316, 0.0), (PI / 2, 0.0, 0.0)),
    ((0.0825, 0.0, 0.0), (PI / 2, 0.0, 0.0)),
    ((-0.0825, 0.384, 0.0), (-PI / 2, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (PI / 2, 0.0, 0.0)),
    ((0.088, 0.0, 0.0), (PI / 2, 0.0, 0.0)),
]
HAND_OFFSET = ((0.0, 0.0, 0.107), (0.0, 0.0, -PI / 4))
EE_OFFSET = np.array([0.0, 0.0, 0.1034])      # tcp in hand frame
PEG_TIP_OFFSET = np.array([0.0, 0.0, 0.19])   # peg tip below the hand

LINK_MASS = [4.97, 0.65, 3.23, 3.59, 1.23, 1.67, 0.74]
JOINT_FORCES = [87.0, 87.0, 87.0, 87.0, 12.0, 120.0, 120.0]
JOINT_LIMIT_LO = [-2.9671, -1.8326, -2.9671, -3.1416, -2.9671, -0.0873, -2.9671]
JOINT_LIMIT_HI = [2.9671, 1.8326, 2.9671, 0.0, 2.9671, 3.8223, 2.9671]
NEUTRAL = [0.0, -1.5, 0.0, -3.0, 0.0, 2.26, 0.79]           # reach neutral
NEUTRAL_PEG = [0.0, 0.41, 0.0, -1.85, 0.0, 2.26, 0.79]
NEUTRAL_CABINET = [-0.2, -0.5, 0.0, -2.6, 0.0, 2.2, 0.79]
FINGER_LIMIT = (0.0, 0.04)
ARM_KP, ARM_KD = 20000.0, 300.0               # arm position servos
FINGER_KP, FINGER_KD, FINGER_FORCE = 200.0, 20.0, 170.0

BASE_POS = (-0.6, 0.0, 0.0)


def _rpy_quat(rpy):
    r, p, y = rpy
    qx = np.array([np.cos(r / 2), np.sin(r / 2), 0, 0])
    qy = np.array([np.cos(p / 2), 0, np.sin(p / 2), 0])
    qz = np.array([np.cos(y / 2), 0, 0, np.sin(y / 2)])

    def mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])

    return tuple(mul(mul(qz, qy), qx))


def panda_bodies(has_peg: bool = False):
    """Robot BodySpec chain + actuator list. ARM_KP saturates the per-joint
    force limit over most of the travel, as PyBullet's stiff
    POSITION_CONTROL does (rationale at
    `ddiffpg_tpu/physics/panda.py:panda_bodies`)."""
    bodies = [BodySpec("base", "", pos=BASE_POS,
                       joint=JointSpec(T.FIXED),
                       geoms=[GeomSpec(T.SPHERE, (0.06,), density=2000.0)])]
    parent = "base"
    actuators = []
    for i, (xyz, rpy) in enumerate(PANDA_JOINTS):
        name = f"link{i + 1}"
        bodies.append(BodySpec(
            name, parent, pos=xyz, quat=_rpy_quat(rpy),
            joint=JointSpec(T.HINGE, axis=(0, 0, 1), armature=0.15,
                            damping=2.0,
                            limit=(JOINT_LIMIT_LO[i], JOINT_LIMIT_HI[i])),
            mass=LINK_MASS[i], inertia_diag=(0.02, 0.02, 0.01),
            geoms=[]))
        actuators.append({"body": name, "kp": ARM_KP, "kd": ARM_KD,
                          "force": JOINT_FORCES[i]})
        parent = name

    hand_geoms = [GeomSpec(T.SPHERE, (0.035,), pos=(0, 0, 0.05),
                           density=1000.0, friction=1.0)]
    if has_peg:
        hand_geoms.append(GeomSpec.capsule_fromto(
            0.012, (0, 0, 0.08), tuple(PEG_TIP_OFFSET), density=500.0))
    bodies.append(BodySpec("hand", parent, pos=HAND_OFFSET[0],
                           quat=_rpy_quat(HAND_OFFSET[1]),
                           joint=JointSpec(T.FIXED), geoms=hand_geoms))
    for f, sign in (("finger1", 1.0), ("finger2", -1.0)):
        bodies.append(BodySpec(
            f, "hand", pos=(0, 0, 0.0584),
            joint=JointSpec(T.SLIDE, axis=(0, sign, 0), armature=0.02,
                            damping=5.0, limit=FINGER_LIMIT),
            mass=0.05, inertia_diag=(1e-4, 1e-4, 1e-4),
            geoms=[GeomSpec(T.SPHERE, (0.012,), pos=(0, sign * 0.01, 0.04),
                            density=1000.0, friction=1.0)]))
        actuators.append({"body": f, "kp": FINGER_KP, "kd": FINGER_KD,
                          "force": FINGER_FORCE})
    return bodies, actuators


def build_panda_scene(task: str, dt=0.002, n_substeps=20):
    """Build the full Model for one of the four reference tasks ("Reach",
    "PegInsertion", "DrawerMulti", "Cabinet"). Returns (model, meta)."""
    meta = {"task": task}
    has_peg = task == "PegInsertion"
    if task == "Cabinet":
        neutral = NEUTRAL_CABINET
    elif has_peg:
        neutral = NEUTRAL_PEG
    else:
        neutral = NEUTRAL
    bodies, actuators = panda_bodies(has_peg)
    static = []
    task_bodies = []

    if task == "Reach":
        # cross-shaped obstacle before the fixed goal
        for pos, ext in ((( -0.22, 0.0, 0.67), (0.02, 0.005, 0.2)),
                         ((-0.22, 0.0, 0.67), (0.02, 0.2, 0.005))):
            p, e = np.array(pos), np.array(ext)
            static.append((p - e, p + e))
        meta["goal"] = np.array([-0.05, 0.0, 0.65])
        meta["threshold"] = 0.1
    elif task == "PegInsertion":
        # two hole blocks on the table: plates with a 3 cm bore at the goal
        for hx, hy in ((0.05, 0.15), (0.05, -0.15)):
            for dx, dy, ex, ey in ((0.05, 0.0, 0.02, 0.07),
                                   (-0.05, 0.0, 0.02, 0.07),
                                   (0.0, 0.05, 0.03, 0.02),
                                   (0.0, -0.05, 0.03, 0.02)):
                c = np.array([hx + dx, hy + dy, 0.015])
                e = np.array([ex, ey, 0.015])
                static.append((c - e, c + e))
        meta["goals"] = np.array([[0.05, 0.15, 0.01], [0.05, -0.15, 0.01]])
        meta["threshold"] = 0.03
    elif task == "DrawerMulti":
        # four drawers, prismatic along -x (toward the robot); init open
        # at 0.17, success when any pushed to <= 0.03
        z_off, x_d, y_off = 0.28, -0.35, 0.185
        poses = [(x_d, -y_off, 0.2 + z_off), (x_d, -y_off, 0.4 + z_off),
                 (x_d, y_off, 0.2 + z_off), (x_d, y_off, 0.4 + z_off)]
        for i, p in enumerate(poses):
            task_bodies.append(BodySpec(
                f"drawer_{i}", "", pos=p,
                joint=JointSpec(T.SLIDE, axis=(-1, 0, 0), damping=20.0,
                                armature=0.0, limit=(0.0, 0.25)),
                mass=1.0, inertia_diag=(0.01, 0.01, 0.01),
                geoms=[GeomSpec(T.BOX, (0.02, 0.08, 0.08), friction=0.8)]))
            # static shell behind each drawer
            c = np.array(p) + np.array([0.12, 0.0, 0.0])
            e = np.array([0.09, 0.1, 0.1])
            static.append((c - e, c + e))
        meta["drawer_init"] = 0.17
        meta["goal"] = 0.03
    elif task == "Cabinet":
        # single revolute door opening about a vertical hinge; success when
        # the joint angle >= 0.4 rad
        hinge_pos = (-0.22, 0.1 + 0.18, 0.53)
        task_bodies.append(BodySpec(
            "door", "", pos=hinge_pos,
            joint=JointSpec(T.HINGE, axis=(0, 0, 1), damping=4.0,
                            armature=0.0, limit=(0.0, 1.6)),
            mass=1.5, inertia_diag=(0.02, 0.02, 0.02),
            geoms=[GeomSpec(T.BOX, (0.02, 0.18, 0.15), pos=(0, -0.18, 0),
                            friction=0.8)]))
        # cabinet shell
        c = np.array([-0.22 - 0.15, 0.1, 0.53])
        e = np.array([0.12, 0.2, 0.18])
        static.append((c - e, c + e))
        meta["goal"] = 0.4
    else:
        raise ValueError(task)

    all_bodies = bodies + task_bodies
    model = build(all_bodies, actuators,
                  static_boxes=np.asarray(static, np.float32)
                  if static else None,
                  dt=dt, n_substeps=n_substeps,
                  contact_timeconst=0.02, contact_dampratio=1.0)

    # init qpos: arm at neutral, task joints at their init values
    init = np.array(model.init_qpos)
    name_order = [b.name for b in all_bodies]
    for i, b in enumerate(all_bodies):
        if b.name.startswith("link"):
            k = int(b.name[4:]) - 1
            init[model.jnt_qposadr[i]] = neutral[k]
        elif b.name.startswith("drawer"):
            init[model.jnt_qposadr[i]] = meta.get("drawer_init", 0.0)
    model = type(model)(**{**model.__dict__,
                           "init_qpos": init.astype(np.float32)})

    meta["arm_body_idx"] = [name_order.index(f"link{i + 1}") for i in range(7)]
    meta["hand_idx"] = name_order.index("hand")
    meta["finger_idx"] = [name_order.index("finger1"),
                          name_order.index("finger2")]
    meta["task_body_idx"] = [name_order.index(b.name) for b in task_bodies]
    meta["neutral"] = np.asarray(neutral, np.float32)
    meta["arm_qposadr"] = np.asarray(
        [model.jnt_qposadr[name_order.index(f"link{i + 1}")]
         for i in range(7)])
    meta["arm_dofadr"] = np.asarray(
        [model.jnt_dofadr[name_order.index(f"link{i + 1}")]
         for i in range(7)])
    meta["finger_qposadr"] = np.asarray(
        [model.jnt_qposadr[i] for i in meta["finger_idx"]])
    meta["task_qposadr"] = np.asarray(
        [model.jnt_qposadr[i] for i in meta["task_body_idx"]], dtype=np.int64)
    meta["ee_offset"] = PEG_TIP_OFFSET if has_peg else EE_OFFSET
    return model, meta


class Arm:
    """One Panda scene's kinematics on one device, built once: the
    model's `engine.Kinematics` and the arm's index and constant tensors,
    so that a control step uploads nothing. `kernel` is None, or the
    scene's `physics/substep_cuda.py:SubstepKernel`, whose entries then
    compute `ee_state`, `ee_point` and `dls_ik`."""

    def __init__(self, model, meta, device: str | torch.device = "cuda"):
        self.kin = engine.Kinematics(model, device)
        dev = self.kin.device
        self.kernel = None
        self.hand = int(meta["hand_idx"])
        self.ee_offset_host = tuple(
            np.asarray(meta["ee_offset"], np.float32).tolist())
        self.ee_offset = torch.as_tensor(
            np.asarray(meta["ee_offset"], np.float32), device=dev)
        body = np.asarray(meta["arm_body_idx"], np.int64)
        self.arm_body_host = tuple(body.tolist())
        self.arm_body = torch.as_tensor(body, device=dev)
        self.arm_axis = torch.as_tensor(
            np.asarray(model.jnt_axis[body], np.float32), device=dev)
        self.arm_qposadr = torch.as_tensor(
            np.asarray(meta["arm_qposadr"], np.int64), device=dev)

    def ee_position(self, body_pos: torch.Tensor, body_quat: torch.Tensor):
        """World position [B, 3] of the end effector (tcp / peg tip)."""
        h = self.hand
        return body_pos[:, h] + Q.rotate(body_quat[:, h], self.ee_offset)

    def ee_point(self, qpos: torch.Tensor):
        """World position [B, 3] of the end effector at qpos: FK and
        `ee_position`; with a kernel, the same in one launch of its IK
        entry (`SubstepKernel.ee_point`)."""
        if self.kernel is not None:
            return self.kernel.ee_point(qpos, self.hand, self.ee_offset_host)
        body_pos, body_quat = self.kin.fk(qpos)
        return self.ee_position(body_pos, body_quat)

    def ee_state(self, qpos: torch.Tensor, qvel: torch.Tensor):
        """The end effector's world position and linear velocity [B, 3]
        each, through `engine.Kinematics` (world-origin subspaces); with a
        kernel, in one launch of its ee-state entry
        (`SubstepKernel.ee_state`)."""
        if self.kernel is not None:
            out = self.kernel.ee_state(qpos, qvel, self.hand,
                                       self.ee_offset_host)
            return out[:, :3], out[:, 3:]
        kin = self.kin
        body_pos, body_quat = kin.fk(qpos)
        p_ee = self.ee_position(body_pos, body_quat)
        S = kin.dof_subspaces(body_pos, body_quat)
        V = kin.body_velocities(S, kin.qvel_to_u(qvel, body_pos))
        h = self.hand
        v_ee = V[:, h, 3:] + torch.linalg.cross(V[:, h, :3], p_ee)
        return p_ee, v_ee

    def ee_jacobian(self, body_pos: torch.Tensor, body_quat: torch.Tensor):
        """(J [B, 3, 7], p_ee [B, 3]): the end effector's positional
        Jacobian w.r.t. the 7 arm joints, column k = cross(the joint's
        world axis, p_ee - the link's origin), as
        `ddiffpg_tpu/physics/panda.py:ee_jacobian`."""
        p_ee = self.ee_position(body_pos, body_quat)
        axis = Q.rotate(body_quat[:, self.arm_body], self.arm_axis)
        cols = torch.linalg.cross(
            axis, p_ee[:, None] - body_pos[:, self.arm_body])   # [B, 7, 3]
        return cols.transpose(1, 2), p_ee

    def dls_ik(self, qpos: torch.Tensor, target: torch.Tensor,
               iters: int = 3, damping: float = 0.05):
        """Damped-least-squares IK for the end effector's position
        `target` [B, 3] from qpos [B, nq]: the 7 arm joint targets [B, 7].
        `iters` steps of dq = J^T (J J^T + damping^2 I)^-1 (target - p),
        each clipped to +-0.2 and added to the arm joints, FK on the full
        qpos at every step, the 3x3 system solved in closed form (three
        cross products over the determinant) as
        `ddiffpg_tpu/physics/panda.py:dls_ik` does. With a kernel, the
        same in one launch of its IK entry (`SubstepKernel.dls_ik`)."""
        if self.kernel is not None:
            return self.kernel.dls_ik(qpos, target, self.arm_body_host,
                                      self.hand, self.ee_offset_host, iters,
                                      damping)
        q = qpos.clone()
        adr = self.arm_qposadr
        eye = torch.eye(3, device=qpos.device)
        for _ in range(iters):
            body_pos, body_quat = self.kin.fk(q)
            J, p = self.ee_jacobian(body_pos, body_quat)
            err = target - p
            A = J @ J.transpose(1, 2) + damping**2 * eye
            a0, a1, a2 = A[..., 0], A[..., 1], A[..., 2]
            c0 = torch.linalg.cross(a1, a2)
            c1 = torch.linalg.cross(a2, a0)
            c2 = torch.linalg.cross(a0, a1)
            det = (a0 * c0).sum(-1, keepdim=True)
            x = torch.stack([(c0 * err).sum(-1), (c1 * err).sum(-1),
                             (c2 * err).sum(-1)], dim=-1) / det
            dq = (J * x[..., None]).sum(1)
            q[:, adr] = q[:, adr] + torch.clamp(dq, -0.2, 0.2)
        return q[:, adr]


def ee_position(meta, body_pos: torch.Tensor, body_quat: torch.Tensor):
    """World position [B, 3] of the end effector (tcp / peg tip) from the
    body frames [B, nb, 3] and [B, nb, 4]."""
    h = meta["hand_idx"]
    off = torch.as_tensor(np.asarray(meta["ee_offset"], np.float32),
                          device=body_pos.device)
    return body_pos[:, h] + Q.rotate(body_quat[:, h], off)


def ee_jacobian(model, meta, body_pos: torch.Tensor, body_quat: torch.Tensor):
    """`Arm.ee_jacobian` of a scene met once."""
    return Arm(model, meta, body_pos.device).ee_jacobian(body_pos, body_quat)


def dls_ik(model, meta, qpos: torch.Tensor, target: torch.Tensor,
           iters: int = 3, damping: float = 0.05):
    """`Arm.dls_ik` of a scene met once."""
    return Arm(model, meta, qpos.device).dls_ik(qpos, target, iters, damping)
