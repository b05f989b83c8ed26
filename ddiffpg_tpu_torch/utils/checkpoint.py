"""Full train-state checkpoints of the port's agent states (DDiffPG's
`DDiffPGState`, the baselines' `TD3State` and SAC's `SACState`).

Counterpart of `ddiffpg_tpu/utils/checkpoint.py:save` and `load`. Every
tensor of the state (the modules' parameters and buffers, the adam states,
the replay tables, the env state, obs, stats, `global_step`, the density
grid, `obs_rms`, SAC's `log_alpha`) is moved to the CPU and written with
`torch.save`, keyed by its path in the state (`critics.weight.0`,
`replay.obs`, ...), beside the host meta the caller passes (the train
loop's: `num_groups`, the scheduler's `last_cluster`,
`lin_start`/`lin_total` and the generators' states, which stand in for the
JAX state's key). `skip` names fields left out by their dotted path:
`("replay",)` writes a light
checkpoint, whose load keeps the example state's fresh replay. The write
is atomic (a temporary file, then a rename). The JAX package's pickles
hold JAX treedefs and are not read here; `utils/convert.py` carries a JAX
state across.

`save_model` / `load_model` are the weights-only bundle of
`ddiffpg_tpu/utils/checkpoint.py:save_model` (the reference's
`model.pth`): the actor, the per-mode critic list, the obs running stats,
the mode embeddings and the coverage grid, as CPU tensors.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch


def leaves(x, prefix: str = ""):
    """(path, tensor) for every tensor of a state: dataclass fields,
    NamedTuple fields, list items, and a module's state_dict (parameters
    and buffers, sharing their storage)."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, torch.nn.Module):
        for k, v in x.state_dict(keep_vars=True).items():
            yield f"{prefix}.{k}", v
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), _join(prefix, f.name))
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k in x._fields:
            yield from leaves(getattr(x, k), _join(prefix, k))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, _join(prefix, str(i)))
    elif x is not None:
        raise TypeError(f"{prefix}: cannot checkpoint {type(x).__name__}")


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _kept(path: str, skip) -> bool:
    return not any(path == s or path.startswith(s + ".") for s in skip)


def save(path, state, host_meta: dict | None = None, skip: tuple = ()) -> int:
    """Write `state` (less the fields whose dotted paths `skip` names) and
    `host_meta` to `path`; returns the file's size in bytes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tensors = {k: v.detach().cpu() for k, v in leaves(state)
               if _kept(k, skip)}
    meta = dict(host_meta or {})
    if skip:
        meta["light"] = True
    tmp = path.with_suffix(".tmp")
    torch.save({"tensors": tensors, "host_meta": meta, "skip": list(skip)},
               tmp)
    tmp.replace(path)
    return path.stat().st_size


@torch.no_grad()
def load(path, example_state):
    """Restore a checkpoint into `example_state` in place, on its devices
    and dtypes (shapes must match); the fields skipped at save time keep
    their values. Returns (state, host_meta)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    skip = blob["skip"]
    tensors = blob["tensors"]
    want = {k: v for k, v in leaves(example_state) if _kept(k, skip)}
    if set(want) != set(tensors):
        missing = sorted(set(want) - set(tensors))
        extra = sorted(set(tensors) - set(want))
        raise ValueError(f"checkpoint {path} does not fit the state: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    for k, dst in want.items():
        src = tensors[k]
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{k}: checkpoint {src.dtype} "
                             f"{tuple(src.shape)}, state {dst.dtype} "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    return example_state, blob["host_meta"]


def _cpu(x):
    """Tensors, modules (their state dicts), NamedTuples (as dicts of their
    fields), dicts and lists -> the same nesting of detached CPU tensor
    copies."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, torch.nn.Module):
        return _cpu(x.state_dict())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _cpu(getattr(x, k)) for k in x._fields}
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_cpu(v) for v in x]
    raise TypeError(f"cannot bundle {type(x).__name__}")


def critic_rows(critics, num_groups: int) -> list:
    """The per-mode critic list of a stacked `DistributionalDoubleQ`: for
    each group g < num_groups, its state dict at row g (`weight.i`
    [2, in, out], `bias.i` [2, out]; heads q1, q2)."""
    return [{k: v[g] for k, v in critics.state_dict().items()}
            for g in range(num_groups)]


def save_model(path, actor, critics: list, rms=None, embeddings=None,
               coverage=None) -> int:
    """Write the weights-only bundle: `actor` (a module or a state dict),
    `critics` (a list of per-mode modules or state dicts, `critic_rows`),
    `rms` (a RunningMeanStd, kept as a dict of its fields), `embeddings`
    and `coverage` (tensors), each optional one as None when not given.
    The write is atomic; returns the file's size in bytes."""
    blob = {"actor": _cpu(actor), "critics": _cpu(list(critics)),
            "rms": _cpu(rms), "embeddings": _cpu(embeddings),
            "coverage": _cpu(coverage)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(blob, tmp)
    tmp.replace(path)
    return path.stat().st_size


def load_model(path) -> dict:
    """The bundle `save_model` wrote, its tensors on the CPU (loaded with
    `weights_only`, so a bundle runs no code)."""
    return torch.load(path, map_location="cpu", weights_only=True)
