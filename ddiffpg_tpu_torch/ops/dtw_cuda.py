"""Build, load and launch the CUDA DTW kernel (`csrc/dtw.cu`).

The kernel replaces the XLA wavefront of `ddiffpg_tpu/ops/dtw.py`
(`dtw_pair` vmapped by `dtw_batch_gather`). It is compiled by `nvcc` for
`sm_90a` at first use, from the source in this package only, into a shared
library with a plain C interface under `build/torch_ext/` at the root of
the checkout, and bound with `ctypes`, as `physics/substep_cuda.py` builds
the substep kernel. Nothing is built or imported until a kernel is asked
for, so the package imports on a machine with neither `nvcc` nor a card.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ddiffpg_tpu_torch.ops.dtw import MAX_DIM, MAX_LEN, check_inputs
from ddiffpg_tpu_torch.physics import substep_cuda

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dtw.cu"
# -fmad=false: no a*b+c contracted into an FMA, so the kernel rounds like
# the plain version (ops/dtw.py:dtw_wavefront) op by op
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
ROWS = (1, 2, 4, 8, 16)   # the kernel's templates of R, rows a lane
WARPS = 4                 # pairs of a block, one warp each
_KERNELS: dict = {}     # device -> DtwKernel
_LIB = None


def launch_geometry(L: int, D: int) -> tuple[int, int, int]:
    """(warps a block, R, shared bytes a block) of a launch on tracks
    padded to L points of D coordinates: R is the least template with
    32 R >= L (a pair of length la uses ceil(la / 32) rows of it), and
    each warp keeps its b in shared memory. L <= MAX_LEN."""
    R = next(r for r in ROWS if 32 * r >= L)
    return WARPS, R, WARPS * D * L * 4


def ptxas_report(log: str) -> dict:
    """ptxas' `-v` lines of a build, by template: (R, D) -> registers,
    stack frame, spill stores and loads (bytes)."""
    return substep_cuda.ptxas_report(
        log, r"dtw_kernelILi(\d+)ELi(\d+)E", lambda m: (int(m[1]), int(m[2])))


def build() -> Path:
    """Compile the kernel (cached by the source's and the flags' hash);
    returns the library's path. ptxas' report is kept as `<name>.log`."""
    return substep_cuda.compile_library(substep_cuda._nvcc(), NVCC_FLAGS,
                                        SOURCE, "dtw")


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.dtw_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.dtw_launch.restype = ctypes.c_int
        lib.dtw_error_string.argtypes = [ctypes.c_int]
        lib.dtw_error_string.restype = ctypes.c_char_p
        if (lib.dtw_max_len(), lib.dtw_max_dim()) != (MAX_LEN, MAX_DIM) \
                or lib.dtw_max_warps() < WARPS:
            raise RuntimeError("csrc/dtw.cu's MAX_L / MAX_D / MAX_WARPS "
                               "differ from ops/dtw.py's MAX_LEN / MAX_DIM "
                               "and WARPS")
        _LIB = lib
    return _LIB


class DtwKernel:
    """DTW distances on the card: (stack_a [Na, L, Dx], stack_b [Nb, L,
    Dx] float32, la_u [Na], lb_u [Nb], ia [P], ib [P] int32) CUDA tensors
    -> [P] float32, one warp a pair, WARPS pairs a block
    (`launch_geometry`). `launches` counts the launches made through this
    object."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DtwKernel needs a CUDA device, got "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = _load()
        self.launches = 0

    def __call__(self, stack_a, stack_b, la_u, lb_u, ia, ib) -> torch.Tensor:
        check_inputs(stack_a, stack_b, la_u, lb_u, ia, ib)
        if stack_a.device != self.device:
            raise ValueError(f"inputs on {stack_a.device}, the kernel on "
                             f"{self.device}")
        P = ia.shape[0]
        L, D = stack_a.shape[1:]
        out = torch.empty((P,), dtype=torch.float32, device=self.device)
        if P == 0:
            return out
        # lengths in [1, L] and indices in range, or the kernel reads past
        # its tracks and its shared copy of b: one host wait a launch
        lo_hi = torch.stack([la_u.min(), lb_u.min(), -la_u.max(),
                             -lb_u.max(), ia.min(), ib.min(), -ia.max(),
                             -ib.max()]).tolist()
        lim = [1, 1, -L, -L, 0, 0, 1 - stack_a.shape[0], 1 - stack_b.shape[0]]
        if any(v < w for v, w in zip(lo_hi, lim)):
            raise ValueError("DTW lengths outside [1, L] or pair indices "
                             "outside the stacks")
        warps, R, _ = launch_geometry(L, D)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.dtw_launch(
            stack_a.data_ptr(), stack_b.data_ptr(), la_u.data_ptr(),
            lb_u.data_ptr(), ia.data_ptr(), ib.data_ptr(), out.data_ptr(),
            P, L, D, R, warps, stream)
        if err:
            raise RuntimeError("DTW launch failed: "
                               + self._lib.dtw_error_string(err).decode())
        self.launches += 1
        return out


def get_kernel(device: str | torch.device = "cuda") -> DtwKernel:
    """The DTW kernel of `device` (one object, and one launch count, a
    device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _KERNELS:
        _KERNELS[device] = DtwKernel(device)
    return _KERNELS[device]
