"""Networks of the port, resolved by class name through `get_model`, with
the names of `ddiffpg_tpu/models/__init__.py`'s registry."""

from ddiffpg_tpu_torch.models import baseline_diffusion, diffusion, mlp

_REGISTRY = {name: getattr(mod, name)
             for mod in (mlp, diffusion, baseline_diffusion)
             for name in mod.__all__}


def get_model(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
