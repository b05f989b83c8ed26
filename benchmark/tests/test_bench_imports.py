"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level module names compared whole: `ddiffpg_tpu_torch` is not
`ddiffpg_tpu`), and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "ddiffpg_tpu")


def _loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m "
            "in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _benchmark_modules() -> list:
    mods = []
    for p in sorted((ROOT / "benchmark").rglob("*.py")):
        rel = p.relative_to(ROOT)
        if rel.parts[1] in ("tests", "metrics"):
            continue
        mods.append(".".join(rel.with_suffix("").parts).removesuffix(
            ".__init__"))
    return mods


def test_the_benchmark_loads_no_jax():
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in _benchmark_modules())
    # every metric reader, and every program module the drivers call
    code += ("from benchmark.harness import cell\n"
             "[cell.reader(p.stem) for p in "
             f"__import__('pathlib').Path({str(ROOT)!r}).joinpath("
             "'benchmark', 'metrics').glob('*.py')]\n"
             "import ddiffpg_tpu_torch.agents.ddiffpg, "
             "ddiffpg_tpu_torch.envs.antmaze, ddiffpg_tpu_torch.envs.panda, "
             "ddiffpg_tpu_torch.train, ddiffpg_tpu_torch.models.diffusion, "
             "ddiffpg_tpu_torch.replay.episodic\n")
    loaded = _loaded_after(code)
    assert "benchmark" in loaded and "ddiffpg_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    mods = [m for m in _benchmark_modules()
            if m.startswith("benchmark.reference")]
    assert "benchmark.reference.follow" in mods
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods)
    loaded = _loaded_after(code)
    assert not loaded & {"ddiffpg_tpu_torch", *BANNED}, loaded


def test_a_tiny_run_loads_no_jax():
    """A whole run of a cell on the CPU, in its own process."""
    code = ("import torch; torch.set_num_threads(2)\n"
            "from benchmark.tests import tiny\n"
            "out = tiny.run('ddiffpg-antmaze-v1.collect')\n"
            "assert out['result']['correct']\n")
    loaded = _loaded_after(code)
    assert not loaded & set(BANNED), loaded & set(BANNED)
