"""Dynamic-time-warping distances between trajectory tracks, batched.

Counterpart of `ddiffpg_tpu/ops/dtw.py` (`dtw_pair` :25, `dtw_batch` :61,
`dtw_batch_gather` :67, `dtw_numpy` :79). The cell cost is the squared
Euclidean distance between two track points, the DP

    D[i, j] = cost(i, j) + min(min(D[i-1, j], D[i, j-1]), D[i-1, j-1])

accumulates along the best warping path, and the distance is the square
root of the terminal cell D[la-1, lb-1].

`dtw_wavefront` is the plain version: one batched PyTorch wavefront over
the anti-diagonals of every pair's table (all cells of a diagonal are
independent), with the JAX package's masking and `_INF` padding. On the
CPU it is what the ClusterManager runs. On a CUDA tensor `dtw_batch_gather`
launches the hand-written kernel `csrc/dtw.cu` (`ops/dtw_cuda.py`)
instead; the plain version then serves only tests and the check of the
kernel. Both sum the cost over the point's coordinates in index order and
take the minimum in the same order, so they round alike.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = 3.4e38
MAX_LEN = 512      # longest track the kernel takes (the cluster's dtw_max_len)
MAX_DIM = 3        # widest track point (xyz on the Panda tasks)


def check_inputs(stack_a, stack_b, la_u, lb_u, ia, ib):
    """Stacks [Na, L, Dx], [Nb, L, Dx] float32, lengths [Na], [Nb] and pair
    indices [P] int32, contiguous, on one device; L <= MAX_LEN, Dx <=
    MAX_DIM."""
    dev = stack_a.device
    for name, t, dt, nd in (("stack_a", stack_a, torch.float32, 3),
                            ("stack_b", stack_b, torch.float32, 3),
                            ("la_u", la_u, torch.int32, 1),
                            ("lb_u", lb_u, torch.int32, 1),
                            ("ia", ia, torch.int32, 1),
                            ("ib", ib, torch.int32, 1)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, stack_a on {dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name}: want {dt} of {nd} dims, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L, D = stack_a.shape[1:]
    if tuple(stack_b.shape[1:]) != (L, D):
        raise ValueError(f"stacks of [.., {L}, {D}] and "
                         f"{tuple(stack_b.shape)}")
    if not (1 <= L <= MAX_LEN and 1 <= D <= MAX_DIM):
        raise ValueError(f"tracks of length {L} and width {D}: the kernel "
                         f"takes L <= {MAX_LEN}, Dx <= {MAX_DIM}")
    if la_u.shape[0] != stack_a.shape[0] or lb_u.shape[0] != stack_b.shape[0]:
        raise ValueError("one length per stacked track")
    if ia.shape != ib.shape:
        raise ValueError(f"ia {tuple(ia.shape)} and ib {tuple(ib.shape)}")


def dtw_terminal(stack_a: torch.Tensor, stack_b: torch.Tensor,
                 la_u: torch.Tensor, lb_u: torch.Tensor, ia: torch.Tensor,
                 ib: torch.Tensor) -> torch.Tensor:
    """The terminal cells D[la-1, lb-1] [P] of the pairs' tables (the
    squared distances), by the plain wavefront. A NaN in a pair's points
    gives NaN: `torch.minimum` propagates it, as `jnp.minimum` does in the
    JAX package (and the kernel's minimum)."""
    check_inputs(stack_a, stack_b, la_u, lb_u, ia, ib)
    P = ia.shape[0]
    dev = stack_a.device
    if P == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    L, Dx = stack_a.shape[1:]
    ia, ib = ia.long(), ib.long()
    a = stack_a[ia]                                   # [P, L, Dx]
    la, lb = la_u[ia].long(), lb_u[ib].long()
    # b padded and reversed: at diagonal d, row i meets column j = d - i,
    # and rb[:, 2L-1-d+i] = b[d-i] (zero off the table, as the JAX pad)
    rb = torch.cat([stack_a.new_zeros((P, L + 1, Dx)), stack_b[ib],
                    stack_a.new_zeros((P, L, Dx))], dim=1).flip(1)
    i_idx = torch.arange(L, device=dev)
    inf = torch.full((P, 1), _INF, dtype=torch.float32, device=dev)
    dm1 = torch.full((P, L), _INF, dtype=torch.float32, device=dev)
    dm2 = dm1.clone()
    target = la + lb - 2
    last_row = (la - 1).clamp(0, L - 1)[:, None]
    acc = torch.full((P,), _INF, dtype=torch.float32, device=dev)
    for d in range(int(target.max()) + 1):
        j = d - i_idx
        valid = (i_idx[None] < la[:, None]) & (j >= 0)[None] \
            & (j[None] < lb[:, None])
        diff = a - rb[:, 2 * L - 1 - d: 3 * L - 1 - d]
        cost = diff[..., 0] * diff[..., 0]
        for k in range(1, Dx):
            cost = cost + diff[..., k] * diff[..., k]
        up = torch.cat([inf, dm1[:, :-1]], dim=1)     # D[i-1, j]
        diag = torch.cat([inf, dm2[:, :-1]], dim=1)   # D[i-1, j-1]
        best = torch.minimum(torch.minimum(up, dm1), diag)
        if d == 0:
            best[:, 0] = 0.0
        cur = torch.where(valid, cost + best, _INF)
        acc = torch.where(target == d, cur.gather(1, last_row)[:, 0], acc)
        dm1, dm2 = cur, dm1
    return acc


def dtw_wavefront(stack_a: torch.Tensor, stack_b: torch.Tensor,
                  la_u: torch.Tensor, lb_u: torch.Tensor, ia: torch.Tensor,
                  ib: torch.Tensor) -> torch.Tensor:
    """The plain version: distances [P] between stack_a[ia[p], :la_u[ia[p]]]
    and stack_b[ib[p], :lb_u[ib[p]]], on the stacks' device: the square
    root of `dtw_terminal`. (On the card `torch.sqrt` rounds correctly, as
    the kernel's `sqrtf`; on the CPU its vector path may miss by an ulp.)"""
    return torch.sqrt(dtw_terminal(stack_a, stack_b, la_u, lb_u, ia, ib))


def dtw_batch_gather(stack_a: torch.Tensor, stack_b: torch.Tensor,
                     la_u: torch.Tensor, lb_u: torch.Tensor,
                     ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """Distances [P] of the pairs (ia, ib) [P] over stacked tracks: each
    track is stored once, and a batch of pairs is two index vectors.
    On a CUDA tensor this launches the kernel `csrc/dtw.cu`; on the CPU it
    runs the plain version."""
    if stack_a.is_cuda:
        from ddiffpg_tpu_torch.ops import dtw_cuda
        return dtw_cuda.get_kernel(stack_a.device)(stack_a, stack_b, la_u,
                                                   lb_u, ia, ib)
    if stack_a.device.type != "cpu":
        raise NotImplementedError(f"DTW on {stack_a.device}")
    return dtw_wavefront(stack_a, stack_b, la_u, lb_u, ia, ib)


def dtw_batch(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
              len_b: torch.Tensor) -> torch.Tensor:
    """Batched DTW of materialised pairs: a, b [P, L, Dx]; len_a, len_b
    [P] -> [P] distances."""
    idx = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return dtw_batch_gather(a, b, len_a, len_b, idx, idx)


def dtw_pair(a: torch.Tensor, b: torch.Tensor, len_a, len_b) -> torch.Tensor:
    """The DTW distance (a 0-d tensor) between a[:len_a] and b[:len_b];
    a, b [L, Dx]: `dtw_batch` of one pair."""
    lens = [torch.as_tensor(n, dtype=torch.int32, device=a.device).reshape(1)
            for n in (len_a, len_b)]
    return dtw_batch(a[None].contiguous(), b[None].contiguous(), *lens)[0]


def dtw_numpy(a, b) -> float:
    """O(L^2) reference DP in float64 numpy (the tests' oracle)."""
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = ((a[i - 1] - b[j - 1]) ** 2).sum()
            D[i, j] = c + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(np.sqrt(D[n, m]))
