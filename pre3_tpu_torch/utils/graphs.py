"""Step programs: the port's counterpart of the JAX package's jitted steps
(``jax.jit(step, donate_argnums=...)``).

A ``StepProgram`` owns the tensors one step of a loop reads and writes:
an input row (one step's frame, step index and draws, packed into one
byte buffer by a ``Packing``), a carry that the step updates in place
(the counterpart of a donated carry: the [D, D] covariance is rewritten,
never reallocated) and an output row. Its buffers are shaped by one
step, so one program serves a sequence or a chunk of any length: the
driver copies step i's packed inputs into the input row before each run
and the output row into row i of the call's own storage after it
(``run_rows``). ``run(variant, body, generators)`` runs
``body(buffers, generators)``, which reads those buffers and writes the
carry and the output row in place:

* on a CUDA device the first run of a variant warms the body once on a
  side stream, puts back every carry buffer the warm-up moved, and
  captures the body into a CUDA graph; every run then replays it. Per
  step the host issues the input copy, the graph launch, before it the
  two fills with which torch seeds each generator registered with the
  graph (the device's default generator is registered with every graph),
  and the output copy;
* on the CPU the body runs eagerly on the same buffers, so the CPU tests
  hold the same step against the JAX package.

A variant that draws takes the caller's generators. On the card the
program's own generators are registered with its graph, set from the
caller's before a replay and copied back after, so one program serves
every caller's generator and a replay draws what the eager step would
draw at the same generator state. A variant given no generators draws
nothing and registers none.

Captures are thread-local (``capture_error_mode="thread_local"``): a
decode thread or another stream's allocations may run during a capture.
A body that cannot be captured raises, naming the last op it
dispatched; nothing falls back to eager launches on the card.

The kernels count their own runs on the device (``utils/launch_count``),
so each replay of a graph that holds K1 or K2 counts as their launch. A
warm-up is set-up whose results are thrown away: its launches pass no
counter (``uncounted``).

Programs are cached by key (``program``): the function, its config and
one step's shapes, dtypes and device. ``clear()`` drops them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import (
    tree_flatten, tree_leaves, tree_unflatten,
)

from pre3_tpu_torch.utils.launch_count import uncounted

# Steps whose packed inputs a driver stages at a time: the input rows a
# call holds besides its caller's stacked inputs.
STAGE_ROWS = 64


class Captured(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    capture_s: float  # warm-up + capture, host seconds
    pool_bytes: int  # device memory the capture reserved


class _OpTrail(TorchDispatchMode):
    """Remembers the last op dispatched, to name it when a capture
    fails."""

    last = "no op"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


class StepProgram:
    """Buffers of one step, and one captured graph per variant of its body
    (see the module docstring)."""

    def __init__(self, name: str, buffers: dict, device: torch.device,
                 n_generators: int = 0, carry: tuple[str, ...] = ()) -> None:
        self.name = name
        self.buffers = buffers
        self.carry = carry  # the buffers the body updates in place
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.generators = [torch.Generator(self.device)
                           for _ in range(n_generators)] if self.cuda else []
        self.graphs: dict[Any, Captured] = {}

    def run(self, variant, body: Callable, generators=()) -> None:
        """``body(buffers, generators)`` once: replayed on the card,
        eager on the CPU. ``generators``: the caller's, one per draw
        stream, for a variant that draws; none for one that does not."""
        if not self.cuda:
            body(self.buffers, list(generators))
            return
        if variant not in self.graphs:
            self.graphs[variant] = self._capture(body, generators)
        self.replay(variant, generators)

    def replay(self, variant, generators=()) -> None:
        """One replay of the captured ``variant`` (``run`` captures it):
        what the host issues per run, and nothing else."""
        self._bind(generators)
        self.graphs[variant].graph.replay()
        for g, p in zip(generators, self.generators):
            g.set_state(p.get_state())

    def run_rows(self, variants, body: Callable, in_rows: torch.Tensor,
                 out_rows: torch.Tensor, generators=()) -> None:
        """One run per entry of ``variants`` (``body(variant)`` is that
        variant's body): input row i of ``in_rows`` copied into the
        ``inp`` buffer before run i, the ``out`` buffer into row i of
        ``out_rows`` after it."""
        inp, out = self.buffers["inp"], self.buffers["out"]
        for i, v in enumerate(variants):
            inp.copy_(in_rows[i])
            self.run(v, body(v), generators)
            out_rows[i].copy_(out)

    def _bind(self, generators) -> list:
        """The program's generators, set from the caller's (none for a
        variant that draws nothing)."""
        if not generators:
            return []
        if len(generators) != len(self.generators):
            raise ValueError(f"{self.name}: {len(generators)} generators for "
                             f"a program of {len(self.generators)}")
        for g, p in zip(generators, self.generators):
            p.set_state(g.get_state())
        return self.generators

    def _capture(self, body: Callable, generators) -> Captured:
        """Warm the body, put the carry back, capture it. The capture
        waits for the device (``torch.cuda.graph`` synchronizes as it
        enters), once per program and variant, with torch's sync debug
        mode suspended: a sync inside the body fails the capture
        itself."""
        t0 = time.perf_counter()
        debug = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            self._warm(body, generators)
            cap = self._record(body, generators)
        finally:
            torch.cuda.set_sync_debug_mode(debug)
        return cap._replace(capture_s=time.perf_counter() - t0)

    def _warm(self, body: Callable, generators) -> None:
        """One eager run on a side stream, not counted (first launches,
        kernel builds, library handles, the kernels' counters and cached
        constants happen outside any capture);
        the carry is put back after it (inputs are only read, outputs
        rewritten by the next run) and the caller's generators are not
        touched, so the first replay gives what the eager step would."""
        bufs = tree_leaves([self.buffers[k] for k in self.carry])
        saved = [t.clone() for t in bufs]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), uncounted():
            body(self.buffers, self._bind(generators))
            for t, s in zip(bufs, saved):
                t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _record(self, body: Callable, generators) -> Captured:
        graph = torch.cuda.CUDAGraph()
        mine = self._bind(generators)
        for p in mine:
            graph.register_generator_state(p)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        trail = _OpTrail()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                with trail:
                    body(self.buffers, mine)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: the step cannot be captured into a CUDA graph; "
                f"the last op dispatched was {trail.last}: {e}") from e
        return Captured(graph, 0.0,
                        torch.cuda.memory_reserved(self.device) - reserved)


_PROGRAMS: dict = {}


def program(key, make: Callable[[], StepProgram]) -> StepProgram:
    """The cached program for ``key``, made by ``make()`` the first
    time. The key names everything the buffers' layout and the captured
    graphs depend on: the function, its config, one step's shapes and
    dtypes, the device and which draws are injected."""
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = make()
    return prog


def programs() -> list[StepProgram]:
    return list(_PROGRAMS.values())


def clear() -> None:
    _PROGRAMS.clear()


def shape_key(*trees) -> tuple:
    """(shape, dtype, device) of every tensor leaf, None for the rest:
    the part of a program key that the inputs decide."""
    return tuple(
        (tuple(t.shape), t.dtype, str(t.device)) if isinstance(
            t, torch.Tensor) else None
        for t in tree_leaves(trees, is_leaf=lambda x: x is None))


def load(dst: Any, src: Any) -> None:
    """Copy ``src``'s tensors into ``dst``'s (same structure), skipping
    those that already are the same tensor."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def empty_like_tree(tree: Any) -> Any:
    """Fresh tensors of ``tree``'s shapes (a NamedTuple of tensors, or
    one tensor); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    return type(tree)(*(empty_like_tree(x) for x in tree))


class Packing:
    """A layout of a tree of tensors (shapes and dtypes of ``example``,
    one step's) in one byte row, each tensor at a 16-byte aligned offset:
    a step's inputs enter a program and its outputs leave it as one copy
    each. Rows may carry leading axes (``rows(n)``: n steps' rows)."""

    def __init__(self, example: Any) -> None:
        self.spec = tree_flatten(example)[1]
        self.fields = []
        off = 0
        for t in tree_leaves(example):  # None stays None
            if t is None:
                self.fields.append(None)
                continue
            self.fields.append((off, t.nbytes, t.dtype, tuple(t.shape)))
            off += -(-t.nbytes // 16) * 16
        self.nbytes = max(off, 16)

    def rows(self, *lead: int, device) -> torch.Tensor:
        """Uninitialised rows [*lead, nbytes] (uint8)."""
        return torch.empty((*lead, self.nbytes), dtype=torch.uint8,
                           device=device)

    def unpack(self, rows: torch.Tensor) -> Any:
        """The tree, as views of ``rows`` ([*lead, nbytes] uint8): each
        tensor with the rows' leading axes in front."""
        lead = tuple(rows.shape[:-1])
        return tree_unflatten(
            [None if f is None else
             rows[..., f[0]:f[0] + f[1]].view(f[2]).view((*lead, *f[3]))
             for f in self.fields], self.spec)

    def pack(self, tree: Any, rows: torch.Tensor) -> None:
        """Copy ``tree``'s tensors (each with the rows' leading axes in
        front) into ``rows``."""
        load(self.unpack(rows), tree)
