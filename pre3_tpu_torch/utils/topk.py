"""Top-k with the reference's tie order.

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
promises no tie order. The port calls top-k on arrays where ties are the
norm (a FAST score map that is mostly zeros, Gumbel scores that are -inf
on every invalid match), so the order is pinned with a stable sort.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis,
    ties in ascending index order (``jax.lax.top_k`` semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
