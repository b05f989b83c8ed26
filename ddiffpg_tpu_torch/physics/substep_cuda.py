"""Build, load and launch the CUDA substep kernel (`csrc/substep.cu`).

The kernel replaces `ddiffpg_tpu/physics/pallas_ant.py:make_substep_kernel`
on an NVIDIA Hopper card. It is compiled by `nvcc` for `sm_90a` at first
use, from the sources in this package only, into a shared library with a
plain C interface under `build/torch_ext/` at the root of the checkout,
and bound with `ctypes` (a binding that includes PyTorch's headers takes
minutes to compile; this one takes seconds). Model sizes are compile-time
defines, as are its Panda-only stages (`HAS_SERVO`, `NDB`), and the
model's arrays go into the kernel's device-memory block once, when the
library is loaded (each block of the kernel copies them to shared memory at
its start), so every distinct model gets its own library file (the build
key hashes the source, the flags and the constants). The launch geometry,
a group of `lanes_for(c)` threads per env and 256 threads a block, is
compile-time too (`launch_geometry`).

Nothing here is imported or built until a kernel is asked for on a CUDA
tensor, so the package imports on a machine with neither `nvcc` nor a card.
The physics is never differentiated (the JAX package takes no gradient
through it), so there is no `autograd.Function`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ddiffpg_tpu_torch.physics.substep import SubstepConstants
from ddiffpg_tpu_torch.physics.types import HINGE

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "substep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
# -fmad=false: no contraction of a*b+c into FMAs, so the kernel rounds like
# the plain version op by op (kernel vs plain on an H100 at 4096 envs: one
# substep 7e-9 qpos / 1e-6 qvel instead of 1e-7 / 2e-6 with contraction,
# ten substeps 1e-7 / 8e-6 instead of 8e-7 / 1e-4; the kernel is ~1% slower)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BLOCK_THREADS = 256
MAX_SHARED_BYTES = 232_448   # dynamic shared memory of one block, H100
# loaded libraries by path: dlopen hands back one handle per path, and its
# model block holds the model it was built for
_LOADED: dict = {}


def _rows(a, dtype) -> np.ndarray:
    """`a` [k, ...], or one row of zeros when k is 0: the kernel declares
    the arrays of an empty table (no static or dynamic boxes) with one."""
    a = np.asarray(a, dtype)
    return a if a.shape[0] else np.zeros((1,) + a.shape[1:], dtype)


def _fields(c: SubstepConstants):
    """(name, ctypes type, numpy value) in the order of
    `struct SubstepModel`."""
    i32, f32 = ctypes.c_int32, ctypes.c_float
    arrays = [
        ("parent", i32, c.parent), ("jnt_type", i32, c.jnt_type),
        ("qposadr", i32, c.qposadr), ("dofadr", i32, c.dofadr),
        ("ident_quat", i32, c.ident_quat),
        ("anc_mask", i32, c.anc_mask), ("axis", f32, c.axis),
        ("body_pos", f32, c.body_pos), ("body_quat", f32, c.body_quat),
        ("mass", f32, c.mass), ("com", f32, c.com),
        ("inertia", f32, c.inertia), ("damping", f32, c.damping),
        ("armature", f32, c.armature), ("lim_lo", f32, c.lim_lo),
        ("lim_hi", f32, c.lim_hi), ("lim_on", i32, c.lim_on),
        ("dof_body", i32, c.dof_body),
        ("act_dof", i32, c.act_dof), ("act_gear", f32, c.act_gear),
        ("act_type", i32, c.act_type), ("act_kp", f32, c.act_kp),
        ("act_kd", f32, c.act_kd), ("act_force", f32, c.act_force),
        ("act_qadr", i32, c.act_qadr),
        ("probe_body", i32, c.probe_body), ("probe_off", f32, c.probe_off),
        ("probe_rad", f32, c.probe_rad), ("probe_fric", f32, c.probe_fric),
        ("probe_kn", f32, c.probe_kn), ("probe_cn", f32, c.probe_cn),
        ("box_min", f32, _rows(c.box_min, np.float32)),
        ("box_max", f32, _rows(c.box_max, np.float32)),
        ("dbox_body", i32, _rows(c.dbox_body, np.int32)),
        ("dbox_ident", i32, _rows(c.dbox_ident, np.int32)),
        ("dbox_pos", f32, _rows(c.dbox_pos, np.float32)),
        ("dbox_quat", f32, _rows(c.dbox_quat, np.float32)),
        ("dbox_half", f32, _rows(c.dbox_half, np.float32)),
        ("dbox_keep", f32, _rows(c.dbox_keep, np.float32)),
        ("gravity", f32, c.gravity)]
    scalars = ["dt", "inv_nb", "capk_scale", "inv_vreb", "vreb", "vtol",
               "vtol_eps", "lim_k", "lim_c", "vmax", "support_f", "m_total",
               "inv_m_total"]
    out = []
    for name, ct, val in arrays:
        a = np.asarray(val, np.int32 if ct is i32 else np.float32).ravel()
        out.append((name, ct * a.size, a))
    out += [(name, f32, np.float32(getattr(c, name))) for name in scalars]
    return out


def model_block(c: SubstepConstants) -> ctypes.Structure:
    """The model constants packed as the kernel's `struct SubstepModel`."""
    fields = _fields(c)

    class SubstepModel(ctypes.Structure):
        _fields_ = [(name, ct) for name, ct, _ in fields]

    block = SubstepModel()
    for name, ct, val in fields:
        if isinstance(val, np.ndarray) and val.ndim == 1:
            getattr(block, name)[:] = val.tolist()
        else:
            setattr(block, name, float(val))
    return block


def lanes_for(c: SubstepConstants) -> int:
    """Threads per env: 16, two envs a warp and 16 a block. Of 8, 16 and
    32, 16 was the fastest for the ant, DrawerMulti and Reach at 4096 envs
    on an H100 (PERF.md, the L sweep): 8 leaves an SM too few warps to
    hide latency, 32 spends twice the issue slots on the serial tree
    walks. A model whose 16 slices do not fit one block's shared memory
    takes 32 (8 slices a block)."""
    return 16 if _shared_bytes(c, 16) <= MAX_SHARED_BYTES else 32


def slice_floats(c: SubstepConstants) -> int:
    """Floats in the kernel's `struct Slice`, one env's state in shared
    memory: what lives through a substep, plus the largest of the union's
    members (FK, contacts, RNEA, CRBA and solve)."""
    nb, nv, npr, ndb = c.nb, c.nv, c.npr, c.ndb
    live = (c.nq + nv + c.nu + nb * (3 + 4 + 3) + 3 + nv * 6 + nv + nb * 6
            + nb * 36 + 1 + nb * 18 + nv + (nv if c.has_servo else 0))
    contacts = 8 * npr + ((6 * npr + 3 * ndb * npr + 6 * ndb) if ndb else 0)
    nlt = nv * (nv + 1) // 2
    return live + max(nb * 4, contacts, nb * 18, nlt + 4 * nv)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _shared_bytes(c: SubstepConstants, lanes: int) -> int:
    return (_round16(ctypes.sizeof(model_block(c)))
            + BLOCK_THREADS // lanes * _round16(4 * slice_floats(c)))


def launch_geometry(c: SubstepConstants, lanes: int | None = None):
    """(lanes per env, envs per block, dynamic shared bytes per block) of
    the kernel built for `c`: the model block, then one `Slice` per env,
    each rounded up to 16 bytes."""
    lanes = lanes_for(c) if lanes is None else int(lanes)
    if lanes not in (8, 16, 32):
        raise ValueError(f"lanes must be 8, 16 or 32, got {lanes}")
    shared = _shared_bytes(c, lanes)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"{shared} bytes of shared memory a block, more "
                         f"than {MAX_SHARED_BYTES}")
    return lanes, BLOCK_THREADS // lanes, shared


def defines(c: SubstepConstants, lanes: int | None = None) -> list:
    lanes, groups, _ = launch_geometry(c, lanes)
    return [f"-D{k}={v}" for k, v in (
        ("LANES", lanes), ("GROUPS", groups),
        ("NB", c.nb), ("NV", c.nv), ("NQ", c.nq), ("NU", c.nu),
        ("NPR", c.npr), ("NSB", c.nsb), ("NDB", c.ndb),
        ("HAS_SERVO", int(c.has_servo)), ("NSUB", c.n_substeps))]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for p in cands:
        if p and os.path.exists(p):
            return p
    raise RuntimeError("nvcc not found: the CUDA substep kernel cannot be "
                       "built on this machine")


def compile_library(compiler: str, flags, source: Path, prefix: str,
                    key_extra: bytes = b"") -> Path:
    """Compile `source` into a shared library under BUILD_DIR with
    `compiler *flags -o <lib> source`, cached by the hash of the source,
    the flags and `key_extra`; the compiler's output is kept beside it as
    `<name>.log`. Returns the library's path; raises if the build fails."""
    key = hashlib.sha256(source.read_bytes())
    key.update(" ".join(flags).encode())
    key.update(key_extra)
    path = BUILD_DIR / f"{prefix}_{key.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(compiler).name} failed ({res.returncode})"
                           f":\n{res.stderr}")
    os.replace(tmp, path)
    return path


def build(c: SubstepConstants, lanes: int | None = None) -> Path:
    """Compile the kernel for these constants (cached by content); returns
    the library's path. The compiler's report (registers, spills) is kept
    beside it as `<name>.log`."""
    return compile_library(_nvcc(), NVCC_FLAGS + tuple(defines(c, lanes)),
                           SOURCE, "substep", bytes(model_block(c)))


def ptxas_report(log: str,
                 entry: str = (r"(substep_kernel|ee_state_kernel"
                               r"|dls_ik_kernel)"),
                 key=lambda m: m[1]) -> dict:
    """ptxas' `-v` lines of a build, by entry: `key` of the match of the
    regex `entry` in the entry's name (default: `substep_kernel`,
    `ee_state_kernel`, `dls_ik_kernel`) -> registers, stack frame, spill
    stores and loads (bytes)."""
    out, compiling, props = {}, None, None

    def find(line):
        m = re.search(entry, line)
        return out.setdefault(key(m), {}) if m else None

    for line in log.splitlines():
        if "Compiling entry" in line:      # then its "Used N registers"
            compiling = find(line)
        elif "Function properties" in line:  # then its stack and spills
            props = find(line)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            props.update(stack=int(m[1]), spill_stores=int(m[2]),
                         spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and compiling is not None:
            compiling["registers"] = int(m[1])
    return out


def build_all(consts) -> list:
    """`build` for several models at once, one nvcc process each, all
    started together; returns their paths in order."""
    consts = list(consts)
    with ThreadPoolExecutor(max_workers=max(len(consts), 1)) as pool:
        return list(pool.map(build, consts))


def _load(c: SubstepConstants, device: torch.device, lanes: int | None):
    path = build(c, lanes)
    lib = _LOADED.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(path))
    lib.substep_model_bytes.restype = ctypes.c_int
    lib.substep_shared_bytes.restype = ctypes.c_int
    lib.substep_set_model.argtypes = [ctypes.c_void_p]
    lib.substep_set_model.restype = ctypes.c_int
    lib.substep_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.substep_launch.restype = ctypes.c_int
    lib.substep_error_string.argtypes = [ctypes.c_int]
    lib.substep_error_string.restype = ctypes.c_char_p
    if c.has_servo:
        lib.ee_state_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.ee_state_launch.restype = ctypes.c_int
        lib.dls_ik_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_uint, ctypes.c_int] + [ctypes.c_float] * 3 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.dls_ik_launch.restype = ctypes.c_int
    block = model_block(c)
    if lib.substep_model_bytes() != ctypes.sizeof(block):
        raise RuntimeError("struct SubstepModel layout differs from its "
                           f"ctypes mirror ({lib.substep_model_bytes()} vs "
                           f"{ctypes.sizeof(block)} bytes)")
    shared = launch_geometry(c, lanes)[2]
    if lib.substep_shared_bytes() != shared:
        raise RuntimeError("struct Slice's size differs from slice_floats "
                           f"({lib.substep_shared_bytes()} vs {shared} "
                           "shared bytes a block)")
    with torch.cuda.device(device):
        torch.cuda.init()
        err = lib.substep_set_model(ctypes.byref(block))
    if err:
        raise RuntimeError("setting up the kernel (model constants, shared "
                           "memory) failed: "
                           + lib.substep_error_string(err).decode())
    lib.device = device
    _LOADED[path] = lib
    return lib


class SubstepKernel:
    """The fused substeps of one model on the card (`model` is a `Model` or
    its `SubstepConstants`, which fix n_substeps):
    (qpos [B, nq], qvel [B, nv], ctrl [B, nu]) float32 CUDA tensors ->
    new (qpos, qvel). Builds and loads the kernel when constructed;
    `lanes` overrides `lanes_for` (threads per env: 8, 16 or 32).

    `launches` counts the substep launches made through this object,
    `ee_launches` those of `ee_state` and `ik_launches` those of the IK
    entry (`dls_ik`, `ee_point`; Panda builds only).
    """

    def __init__(self, model, device: str | torch.device = "cuda",
                 lanes: int | None = None):
        c = model if isinstance(model, SubstepConstants) \
            else SubstepConstants.from_model(model)
        self.consts = c
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"SubstepKernel needs a CUDA device, got "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.lanes, self.groups, self.shared_bytes = launch_geometry(c, lanes)
        self._lib = _load(c, self.device, lanes)
        if self._lib.device != self.device:
            raise RuntimeError("this model's kernel is loaded on "
                               f"{self._lib.device}, not {self.device}")
        self.launches = 0
        self.ee_launches = 0
        self.ik_launches = 0

    def _check(self, **inputs):
        """Each input float32 [B, width], contiguous, on the kernel's
        device; returns B."""
        c = self.consts
        widths = {"qpos": c.nq, "qvel": c.nv, "ctrl": c.nu, "target": 3}
        B = inputs["qpos"].shape[0]
        for name, t in inputs.items():
            w = widths[name]
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the kernel on "
                                 f"{self.device}")
            if t.dtype != torch.float32 or tuple(t.shape) != (B, w):
                raise ValueError(f"{name}: want float32 [{B}, {w}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        return B

    def _raise_on(self, err: int, what: str):
        if err:
            raise RuntimeError(f"{what} launch failed: "
                               + self._lib.substep_error_string(
                                   err).decode())

    def __call__(self, qpos: torch.Tensor, qvel: torch.Tensor,
                 ctrl: torch.Tensor):
        B = self._check(qpos=qpos, qvel=qvel, ctrl=ctrl)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.substep_launch(
            qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(),
            qpos_out.data_ptr(), qvel_out.data_ptr(), B, stream)
        self._raise_on(err, "substep")
        self.launches += 1
        return qpos_out, qvel_out

    def ee_state(self, qpos: torch.Tensor, qvel: torch.Tensor, hand: int,
                 offset):
        """The end effector's world position and linear velocity
        [B, 6] = [p_ee, v_ee] of (qpos [B, nq], qvel [B, nv]): the point
        `offset` (3 floats, in the frame of body `hand`), in one launch of
        `ee_state_kernel` on the current stream (a Panda build's second
        entry; `envs/panda.py:PandaTaskEnv._ee_state`)."""
        if not self.consts.has_servo:
            raise ValueError("ee_state: this model's build has no "
                             "end-effector entry (no servos)")
        if not 0 <= hand < self.consts.nb:
            raise ValueError(f"ee_state: body {hand} of {self.consts.nb}")
        B = self._check(qpos=qpos, qvel=qvel)
        out = torch.empty((B, 6), dtype=torch.float32, device=self.device)
        ox, oy, oz = (float(x) for x in offset)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.ee_state_launch(
            qpos.data_ptr(), qvel.data_ptr(), out.data_ptr(), hand, ox, oy,
            oz, B, stream)
        self._raise_on(err, "ee_state")
        self.ee_launches += 1
        return out

    def _ik_launch(self, qpos, target, q_out, p_out, arm_body, hand: int,
                   offset, iters: int, damping: float):
        """One launch of `dls_ik_kernel`; `target`, `q_out` and `p_out`
        may each be None (no target read, no joints or no point written)."""
        c = self.consts
        if not c.has_servo:
            raise ValueError("this model's build has no IK entry (no "
                             "servos)")
        if (arm_body != sorted(set(arm_body))
                or any(not 0 <= i < min(c.nb, 32) or c.jnt_type[i] != HINGE
                       for i in arm_body)):
            raise ValueError(f"arm bodies {arm_body} must be increasing "
                             f"hinges of the {c.nb} bodies")
        if not 0 <= hand < c.nb:
            raise ValueError(f"body {hand} of {c.nb}")
        ox, oy, oz = (float(x) for x in offset)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.dls_ik_launch(
            qpos.data_ptr(), target.data_ptr() if target is not None else None,
            q_out.data_ptr() if q_out is not None else None,
            p_out.data_ptr() if p_out is not None else None,
            sum(1 << i for i in arm_body), hand, ox, oy, oz, iters,
            float(damping) ** 2, qpos.shape[0], stream)
        self._raise_on(err, "dls_ik")
        self.ik_launches += 1

    def dls_ik(self, qpos: torch.Tensor, target: torch.Tensor, arm_body,
               hand: int, offset, iters: int, damping: float):
        """`physics/panda.py:Arm.dls_ik` bit for bit as the plain PyTorch
        computes it on the card, in one launch of `dls_ik_kernel` on the
        current stream (a Panda build's third entry): from qpos [B, nq],
        `iters` damped-least-squares steps that move the hinges of the
        bodies `arm_body` (increasing) to put the point `offset` (3 floats,
        in the frame of body `hand`) at `target` [B, 3]; returns those
        joints' qpos [B, len(arm_body)]."""
        arm_body = [int(i) for i in arm_body]
        B = self._check(qpos=qpos, target=target)
        out = torch.empty((B, len(arm_body)), dtype=torch.float32,
                          device=self.device)
        self._ik_launch(qpos, target, out, None, arm_body, hand, offset,
                        int(iters), damping)
        return out

    def ee_point(self, qpos: torch.Tensor, hand: int, offset):
        """`Arm.ee_point` (Kinematics.fk and `Arm.ee_position`) bit for bit
        as the plain PyTorch computes it on the card: the world position
        [B, 3] of the point `offset` in the frame of body `hand`, in one
        launch of the IK entry with no iterations."""
        B = self._check(qpos=qpos)
        out = torch.empty((B, 3), dtype=torch.float32, device=self.device)
        self._ik_launch(qpos, None, None, out, [], hand, offset, 0, 0.0)
        return out
