"""Mode-embedding mixing (counterpart of `ddiffpg_tpu/ops/embedding.py`).

A fraction `p` of the env batch acts in exploit mode — conditioned on the
per-mode embeddings (the first s = floor(N p) rows, split over the modes)
or, with no modes yet, on the zero embedding (a random subset of s rows);
the other rows are conditioned on the explore embedding. `num_modes` stays
a tensor: both branches are computed and one is selected with
`torch.where`, so choosing needs no host sync.
"""

from __future__ import annotations

import torch


def generate_embedding(dim: int, *, generator: torch.Generator,
                       device: str | torch.device | None = None
                       ) -> torch.Tensor:
    """A random N(0, 1) mode id [dim] (the reference's torch_util.py:14-15),
    drawn from `generator` on its device unless `device` is given."""
    return torch.randn((dim,), generator=generator,
                       device=generator.device if device is None else device)


def add_embedding(state: torch.Tensor, embedding: torch.Tensor, p,
                  modes: torch.Tensor | None = None, num_modes=0, *,
                  generator: torch.Generator | None = None,
                  zero_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Concat [state, per-row embedding].

    state [N, D]; embedding [E] (explore); p in [0, 1]; modes [K_max, E]
    (rows >= num_modes unused); num_modes an int or int tensor. `zero_mask`
    [N] bool, the no-modes branch's random subset, is drawn from
    `generator` when not given.
    """
    N = state.shape[0]
    E = embedding.shape[-1]
    dev = state.device
    p32 = torch.as_tensor(p, dtype=torch.float32, device=dev)
    s = torch.floor(N * p32).to(torch.int32)
    base_emb = embedding.to(state.dtype).expand(N, E)
    rows = torch.arange(N, device=dev, dtype=torch.int32)
    if modes is None:
        modes = torch.zeros((1, E), dtype=state.dtype, device=dev)
        num_modes = 0
    num_modes = torch.as_tensor(num_modes, dtype=torch.int32, device=dev)

    # with modes: sizes [base + rem, base, base, ...] as in the reference
    m = torch.clamp(num_modes, min=1)
    base = torch.div(s, m, rounding_mode="floor")
    rem = s - base * m
    idx = torch.where(rows < base + rem, 0,
                      torch.div(rows - rem, torch.clamp(base, min=1),
                                rounding_mode="floor"))
    idx = torch.minimum(torch.clamp(idx, min=0), m - 1).long()
    with_modes = torch.where((rows < s)[:, None], modes.to(state.dtype)[idx],
                             base_emb)

    # without modes: a random subset of s rows gets the zero embedding
    if zero_mask is None:
        perm = torch.randperm(N, generator=generator, device=dev)
        zero_mask = perm < s
    without_modes = torch.where(zero_mask[:, None],
                                torch.zeros_like(base_emb), base_emb)

    new_emb = torch.where(num_modes > 0, with_modes, without_modes)
    return torch.cat([state, new_emb], dim=-1)


def append_embedding(state: torch.Tensor,
                     embedding: torch.Tensor) -> torch.Tensor:
    """add_embedding with p = 0: every row gets `embedding`."""
    N = state.shape[0]
    emb = embedding.to(state.dtype).expand(N, embedding.shape[-1])
    return torch.cat([state, emb], dim=-1)
