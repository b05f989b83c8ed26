"""Metrics sink: console + JSONL, optionally W&B.

Copy of `ddiffpg_tpu/utils/logger.py`. W&B attaches on top when asked for
and importable. `log_image` writes a PNG through matplotlib, imported when
it is called; it raises where matplotlib is missing, and the train loop's
plot block reports that (`train.py:plot_eval`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class Logger:
    def __init__(self, logdir: str, run_name: str | None = None,
                 use_wandb: bool = False, config: dict | None = None):
        run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = Path(logdir) / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._t0 = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project="ddiffpg_tpu", name=run_name,
                                        config=config or {})
            except Exception as e:  # offline / not installed
                print(f"[logger] wandb unavailable ({e}); JSONL only")
        if config:
            with open(self.dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict, step: int):
        rec = {"step": step, "wall": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)

    def log_image(self, name: str, image, step: int):
        """image: HxWx3 uint8 numpy array -> `<name, / as _>_<step>.png` in
        the run directory (+W&B)."""
        import matplotlib.image as mpimg

        mpimg.imsave(self.dir / f"{name.replace('/', '_')}_{step}.png", image)
        if self.wandb:
            import wandb

            self.wandb.log({name: wandb.Image(image)}, step=step)

    def console(self, msg: str):
        print(f"[{time.time() - self._t0:8.1f}s] {msg}", flush=True)

    def close(self):
        self._f.close()
