"""Per-phase SM cycles of the CUDA substep kernel, on one card.

    python3 -m ddiffpg_tpu_torch.tools.phase_clocks [--lanes N]

No kernel profiler runs on every machine with a card, so this tool builds
an instrumented copy of `csrc/substep.cu` under `build/`: after each group
barrier of a substep, lane 0 of every group reads `clock64()` and adds the
cycles since the previous barrier to that phase's counter; the counters are
summed over the groups of a launch. For the ant (antmaze-v1, 10 substeps),
PandaDrawerMultiJoints-v3 and PandaReachJoints-v3 (20 each), one launch at
4096 envs (the states `time_substep` draws), it prints each phase's cycles
per substep per group and its share, largest first (the Cholesky's column
phases summed as one). The cycles are wall time seen by one group: they
include waiting for issue slots that the group shares with the others on
its SM. The kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ddiffpg_tpu_torch.physics import substep_cuda

MAX_PHASES = 96

_BARRIER = '''#define PHASE(fn)         \\
  do {                    \\
    fn(m, s, lane);       \\
    __syncwarp(mask);     \\
  } while (0)
#define PHASE_J(fn, j)    \\
  do {                    \\
    fn(m, s, lane, j);    \\
    __syncwarp(mask);     \\
  } while (0)'''
_GROUP = '''__device__ void substep_group(const SubstepModel& m, Slice& s, int lane,
                              unsigned mask) {'''
_MODEL = '__device__ SubstepModel c_m;'
_LOOP = '''#pragma unroll 1
  for (int t = 0; t < NSUB; ++t) substep_group(m, s, lane, mask);'''


def instrument(src: str) -> str:
    """The kernel source with a cycle counter after every phase barrier
    and `substep_phase_cycles(out)` to read the sums."""
    for anchor in (_BARRIER, _GROUP, _MODEL, _LOOP):
        if src.count(anchor) != 1:
            raise ValueError("csrc/substep.cu no longer has the text the "
                             f"instrumentation hooks into:\n{anchor}")
    tick = ("{ __syncwarp(mask); const long long t_ = clock64(); "
            "pc[pc_i++] += t_ - pc_t; pc_t = t_; }")
    src = src.replace(_BARRIER, (
        f"#define PHASE(fn) do {{ fn(m, s, lane); {tick} }} while (0)\n"
        f"#define PHASE_J(fn, j) do {{ fn(m, s, lane, j); {tick} }} "
        "while (0)"))
    src = src.replace(_GROUP, _GROUP.replace(
        "unsigned mask) {",
        "unsigned mask, long long* pc,\n"
        "                              long long& pc_t) {\n  int pc_i = 0;"))
    src = src.replace(_MODEL, _MODEL + f'''
__device__ unsigned long long g_pc[{MAX_PHASES}], g_groups;
extern "C" int substep_phase_cycles(unsigned long long* out) {{
  cudaError_t err = cudaMemcpyFromSymbol(out, g_pc, sizeof(g_pc));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + {MAX_PHASES}, g_groups, 8);
  return (int)err;
}}''')
    return src.replace(_LOOP, f'''long long pc[{MAX_PHASES}];
  for (int i = 0; i < {MAX_PHASES}; ++i) pc[i] = 0;
  long long pc_t = clock64();
#pragma unroll 1
  for (int t = 0; t < NSUB; ++t) substep_group(m, s, lane, mask, pc, pc_t);
  if (lane == 0) {{
    for (int i = 0; i < {MAX_PHASES}; ++i)
      atomicAdd(&g_pc[i], (unsigned long long)pc[i]);
    atomicAdd(&g_groups, 1ull);
  }}''')


def phase_names(src: str, c) -> list:
    """The phases of one substep for constants `c`, in the order the
    counters are filled: the PHASE calls of `substep_group`, without the
    stages `c` does not build, the Cholesky's column phase once per dof."""
    body = src[src.index(_GROUP):]
    body = body[:body.index("\n}\n")]
    if not c.has_servo:
        body = re.sub(r"#if HAS_SERVO.*?#endif", "", body, flags=re.S)
    if not c.ndb:
        body = re.sub(r"#if NDB > 0.*?#endif", "", body, flags=re.S)
    names = []
    for name in re.findall(r"PHASE(?:_J)?\((\w+)", body):
        names += ["cholesky"] * c.nv if name == "ph_chol_column" else [name]
    if len(names) > MAX_PHASES:
        raise ValueError(f"{len(names)} phases, more than {MAX_PHASES}")
    return names


def main() -> int:
    from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
    from ddiffpg_tpu_torch.physics.panda import build_panda_scene
    from ddiffpg_tpu_torch.physics.substep import SubstepConstants
    from ddiffpg_tpu_torch.tools.time_substep import ant_states, panda_states

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_clocks: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    src = substep_cuda.SOURCE.read_text()
    path = substep_cuda.BUILD_DIR / "substep_phase_clocks.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(instrument(src))
    substep_cuda.SOURCE = path   # this process builds the copy only
    ant = AntMazeEnv(random_init=True, device="cpu").model
    cases = {"ant": (ant, ant_states(np.asarray(ant.init_qpos), 0))}
    for task in ("DrawerMulti", "Reach"):
        m, meta = build_panda_scene(task)
        cases[task] = (m, panda_states(m, meta, 1))
    for name, (m, args) in cases.items():
        c = SubstepConstants.from_model(m)
        kern = substep_cuda.SubstepKernel(c, lanes=a.lanes)
        kern(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (MAX_PHASES + 1))()
        read = kern._lib.substep_phase_cycles
        read.argtypes = [ctypes.c_void_p]
        if read(buf):
            raise RuntimeError("reading the phase counters failed")
        scale = buf[MAX_PHASES] * c.n_substeps
        cycles = {}
        for i, phase in enumerate(phase_names(src, c)):
            cycles[phase] = cycles.get(phase, 0.0) + buf[i] / scale
        total = sum(cycles.values())
        print(f"{name} ({kern.lanes} lanes per env): {total:.0f} cycles per "
              f"substep per group [{smi}]")
        for phase, cyc in sorted(cycles.items(), key=lambda x: -x[1]):
            print(f"  {phase:22s} {cyc:9.0f} {cyc / total:6.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
