"""NeRF-style positional encoding for the intrinsic-novelty nets.

Counterpart of `ddiffpg_tpu/ops/posenc.py` (the reference's Embedder,
utils/intrinsic.py:123-175): the input, then [sin(f_k x), cos(f_k x)]
interleaved per frequency f_k = 2^k, k = 0..L-1.
"""

from __future__ import annotations

import torch


def posenc_dim(input_dims: int, L: int, include_input: bool = True) -> int:
    return input_dims * ((1 if include_input else 0) + 2 * L)


def posenc(x: torch.Tensor, L: int, include_input: bool = True):
    """x [..., d] -> [..., d (include + 2L)]: x, sin f0 x, cos f0 x, ..."""
    freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)   # [L]
    xf = x[..., None, :] * freqs[:, None]                  # [..., L, d]
    flat = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(
        *x.shape[:-1], 2 * L * x.shape[-1])
    return torch.cat([x, flat], dim=-1) if include_input else flat
