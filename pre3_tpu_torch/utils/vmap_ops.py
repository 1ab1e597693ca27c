"""What the kernels' custom ops share to be reachable by ``torch.func.vmap``.

Each kernel wrapper calls a ``torch.library.custom_op`` whose vmap rule
moves the batch axis of every argument to the front (``to_front``) and
calls the op again: one launch with a leading sequence axis. The op takes
one such axis at most, so a second vmap level raises, and the ctypes
launches refuse a vmapped tensor (``check_not_batched``): such a tensor
has no storage of its own to hand to a kernel, and nothing may fall back
to a loop over the sequences.
"""

from __future__ import annotations

import torch


def to_front(size: int, in_dims, args) -> list:
    """Each argument with its vmapped axis moved to the front; an
    unbatched one (dim None) expanded to ``size`` along a new front
    axis; all contiguous. ``None`` arguments (absent optionals) stay
    None."""
    out = []
    for x, d in zip(args, in_dims):
        if x is None:
            out.append(None)
            continue
        x = x.movedim(d, 0) if d is not None else x.expand(size, *x.shape)
        out.append(x.contiguous())
    return out


def check_not_batched(name: str, *xs) -> None:
    """Raise if a vmapped tensor reached a kernel launch directly."""
    is_batched = torch._C._functorch.is_batchedtensor
    if any(x is not None and is_batched(x) for x in xs):
        raise RuntimeError(
            f"{name}: a vmapped tensor reached the kernel launch; under "
            "torch.func.vmap the kernel is reached through its custom op, "
            "whose vmap rule makes one batched launch")
