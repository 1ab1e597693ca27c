"""What the hand kernels' wrappers share (K1–K4).

Each hand kernel is a ``csrc/<name>.cu`` with a plain C interface::

    int <name>_launch(<input pointers>, int S, <sizes>, <constants>,
                      <output pointers>, cudaStream_t stream, int *count);
    int <name>_floor_launch(<the launch configuration's sizes>,
                            cudaStream_t stream);

(the floor: an empty kernel at the same configuration, for timing). Its
op module declares it once as a ``HandKernel`` and gives the launch
(its checks, its outputs, ``HandKernel.launch``), the fake and the plain
version, all three functions of the custom op's arguments. The rules:

- The public wrapper sends CPU tensors straight to the plain version,
  CUDA tensors through the custom op, and raises on any other device
  (``HandKernel.on_cpu``): nothing falls back.
- The custom op (``HandKernel.define``) takes one leading sequence axis
  at most. Its vmap rule moves every tensor argument's batch axis to the
  front and calls the op again, so S sequences are ONE launch; a second
  vmap level raises. On CPU tensors the op runs the plain version per
  sequence, which the tests hold the vmap rule to.
- A launch refuses a vmapped tensor: such a tensor has no storage of
  its own to hand to a kernel.
- Each run of a kernel adds one to its wrapper's ``Counted`` counter on
  the device (``utils/launch_count``).
"""

from __future__ import annotations

import ctypes

import torch

from pre3_tpu_torch.utils.cuda_build import load_library


def to_front(size: int, in_dims, args) -> list:
    """Each tensor argument with its vmapped axis moved to the front, an
    unbatched one expanded to ``size`` along a new front axis, all
    contiguous; anything else (an absent optional, a float) as it is."""
    out = []
    for x, d in zip(args, in_dims):
        if isinstance(x, torch.Tensor):
            x = x.movedim(d, 0) if d is not None else x.expand(size, *x.shape)
            x = x.contiguous()
        out.append(x)
    return out


class HandKernel:
    """One hand kernel: its library ``name``, the public ``wrapper`` its
    messages name, its first argument ``arg`` and that argument's shape
    without the sequence axis (``shape``, as messages print it), its
    launch's numbers of input and output pointers, the ctypes of the
    launch's scalars after S (sizes, then constants) and of its floor
    launch's arguments."""

    def __init__(self, name: str, wrapper: str, *, arg: str, shape: str,
                 inputs: int, scalars: list, outputs: int,
                 floor: list) -> None:
        self.name, self.wrapper, self.arg, self.shape = name, wrapper, arg, shape
        self.rank = shape.count(",") + 1
        self._argtypes = {
            f"{name}_launch": [ctypes.c_void_p] * inputs + [ctypes.c_int]
            + scalars + [ctypes.c_void_p] * (outputs + 2),
            f"{name}_floor_launch": floor}
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        """The kernel's library, built and loaded at the first call."""
        if self._lib is None:
            lib = load_library(self.name)
            for fn, types in self._argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def on_cpu(self, x: torch.Tensor) -> bool:
        """True on the CPU (the plain version), False on CUDA (the
        kernel); any other device raises."""
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.wrapper}: no kernel for device {x.device}")
        return x.device.type == "cpu"

    def check(self, name: str, x: torch.Tensor, dtype: torch.dtype,
              shape: tuple, device: torch.device) -> None:
        """Raise unless argument ``name`` is what the kernel takes."""
        if x.dtype != dtype or tuple(x.shape) != shape or (
            x.device != device or not x.is_contiguous()
        ):
            raise ValueError(
                f"{self.wrapper}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}; got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}, contiguous={x.is_contiguous()}")

    def lead(self, *xs) -> tuple:
        """The launch's leading axes, () or (S,), read off its first
        argument; raises on a vmapped tensor, on a device without the
        kernel and on more than one sequence axis."""
        is_batched = torch._C._functorch.is_batchedtensor
        if any(x is not None and is_batched(x) for x in xs):
            raise RuntimeError(
                f"{self.wrapper}: a vmapped tensor reached the kernel launch; "
                "under torch.func.vmap the kernel is reached through its "
                "custom op, whose vmap rule makes one batched launch")
        x = xs[0]
        if x.device.type != "cuda":
            raise ValueError(f"{self.wrapper}: no kernel for device {x.device}")
        if x.dim() not in (self.rank, self.rank + 1):
            raise ValueError(
                f"{self.wrapper}: {self.arg} must be [{self.shape}] or "
                f"[S, {self.shape}]; got {tuple(x.shape)}")
        return tuple(x.shape[:-self.rank])

    def launch(self, counted, lead: tuple, ins, outs, sizes: dict,
               consts: tuple = ()) -> None:
        """Run the kernel on the inputs' device's current stream: ``ins``
        (None is a null pointer), S, ``sizes``' values, ``consts``,
        ``outs``, counted on ``counted``'s counter. Nothing runs when the
        outputs are empty; a failed launch raises."""
        if outs[0].numel() == 0:
            return
        n_seq, device = lead[0] if lead else 1, ins[0].device
        fn = getattr(self.lib(), f"{self.name}_launch")
        count = counted.pointer(device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*(0 if x is None else x.data_ptr() for x in ins), n_seq,
                    *sizes.values(), *consts, *(o.data_ptr() for o in outs),
                    stream, count)
        if rc != 0:
            dims = ", ".join(f"{k}={v}" for k, v in sizes.items())
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError "
                               f"{rc} (S={n_seq}, {dims})")

    def define(self, qualname: str, schema: str, launch, plain, fake) -> None:
        """Make the kernel's custom op ``self.op``: ``launch`` on CUDA
        tensors, ``plain`` per sequence on CPU tensors, ``fake`` for
        shapes, and the vmap rule."""

        def run(*args):
            x = args[0]
            if x.dim() > self.rank + 1:
                raise RuntimeError(
                    f"{self.wrapper}: nested vmap is not supported; the "
                    f"kernel takes one sequence axis ({self.arg} "
                    f"{tuple(x.shape)})")
            if x.device.type != "cpu":
                return launch(*args)
            if x.dim() == self.rank:
                return plain(*args)
            rows = [plain(*(a[i] if isinstance(a, torch.Tensor) else a
                            for a in args)) for i in range(x.shape[0])]
            if isinstance(rows[0], torch.Tensor):
                return torch.stack(rows)
            return tuple(torch.stack(col) for col in zip(*rows))

        op = torch.library.custom_op(qualname, run, mutates_args=(),
                                     schema=schema)
        op.register_fake(fake)

        @op.register_vmap
        def _vmap(info, in_dims, *args):
            out = op(*to_front(info.batch_size, in_dims, args))
            return out, (0,) * len(out) if isinstance(out, tuple) else 0

        self.op = op
