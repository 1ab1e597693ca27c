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

A program is run from outside any capture. A body captured into one
program must call the plain functions, never another program: a graph
cannot be replayed inside another's capture, so ``program`` and ``run``
raise there, naming both programs, before a buffer is made or written
(``OnlineSlam``'s frame body calls the frontend's plain body, not the
frontend's program).

Each program's graphs share one memory pool. Programs made with the
same ``pool`` name share theirs too (the frontend's, one per frame count
and config): a capture keeps nothing alive in the pool, since a body
writes what it hands on into buffers made outside the capture, so the
pool holds the largest graph's temporaries, not their sum. Their
replays must not overlap: a replay on another stream than the pool's
last waits for that one to end.

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
``call_program`` serves a function whose call is a few runs of its
variants (ICP, GICP, PnP, the bootstrap): its inputs copied in by one
grouped copy per dtype, its packed result row out by one copy
(``packed_result``).

``eager()`` runs every program's bodies eagerly on its buffers on the
card too, as on the CPU, while it is open: the plain loop a smoke run
holds the replays to. Nothing opens it implicitly.

A variant's graph is keyed by (variant, whether the tracer is on;
``utils/profiling``). With tracing off the graphs hold what the body
launches and nothing else. With tracing on a run brackets the body with
the probes ``<program name>.begin`` and ``.end`` (eager on the CPU,
captured into the graph on the card), and the host's side is recorded
as spans: ``graphs.capture`` (and the counter ``graphs.captures.<program
name>``), ``graphs.replay`` (the replay's host time: the generators'
binding and the graph launch; counter ``graphs.replays``) and
``graphs.copy_in``/``graphs.copy_out`` around ``run_rows``' copies.
When tracing turns off every program drops its traced graphs
(``drop_traced``), whose probe nodes hold the tracer's ring.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import (
    tree_flatten, tree_leaves, tree_unflatten,
)

from pre3_tpu_torch.utils import profiling
from pre3_tpu_torch.utils.launch_count import uncounted

# Steps whose packed inputs a driver stages at a time: the input rows a
# call holds besides its caller's stacked inputs.
STAGE_ROWS = 64

# the programs whose bodies are being captured (outermost first), and
# whether eager() is open
_CAPTURING: list[str] = []
_EAGER = False
# every program made, cached or not (drop_traced)
_ALL: weakref.WeakSet = weakref.WeakSet()


def _refuse_in_capture(name: str) -> None:
    """Raise if the current stream is capturing a graph (see the module
    docstring)."""
    if torch.cuda.is_current_stream_capturing():
        outer = _CAPTURING[-1] if _CAPTURING else "a capture"
        raise RuntimeError(
            f"{name}: run while {outer} is being captured; a captured body "
            f"calls the plain function, not the program")


@contextlib.contextmanager
def eager():
    """Run every program's bodies eagerly on their buffers while open,
    on the card as on the CPU (see the module docstring)."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


class Captured(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    capture_s: float  # warm-up + capture, host seconds
    pool_bytes: int  # device memory the capture added to its pool


class Pool:
    """A graph memory pool shared by several programs' graphs, and the
    end of its last replay (see the module docstring)."""

    def __init__(self, handle) -> None:
        self.handle = handle
        self.bytes = 0  # reserved by the captures into it
        self.graphs = 0
        self.done = torch.cuda.Event()
        self.stream = None  # of the last replay

    def order(self, stream) -> None:
        """Before a replay on ``stream``: wait for the last replay if it
        ran on another stream."""
        if self.stream is not None and self.stream != stream:
            stream.wait_event(self.done)

    def replayed(self, stream) -> None:
        self.done.record(stream)
        self.stream = stream


# shared pools by (name, device)
_POOLS: dict = {}


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
                 n_generators: int = 0,
                 carry: tuple[str, ...] | str = (),
                 pool: str | None = None) -> None:
        self.name = name
        self.buffers = buffers
        # the name of a pool shared with other programs' graphs; None:
        # a pool of this program's own
        self.pool = pool
        # the buffers the body updates in place; "all": every buffer
        # there is when a variant is warmed (a body split into variants
        # that hand each other their state through the buffers)
        self.carry = carry
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.generators = [torch.Generator(self.device)
                           for _ in range(n_generators)] if self.cuda else []
        # by (variant, traced)
        self.graphs: dict[tuple[Any, bool], Captured] = {}
        _ALL.add(self)

    def run(self, variant, body: Callable, generators=()) -> None:
        """``body(buffers, generators)`` once: replayed on the card,
        eager on the CPU. ``generators``: the caller's, one per draw
        stream, for a variant that draws; none for one that does not.
        Raises inside another capture (see the module docstring)."""
        if self.cuda:
            _refuse_in_capture(self.name)
        if not self.cuda or _EAGER:
            self._probed(body)(self.buffers, list(generators))
            return
        key = (variant, profiling.on())
        if key not in self.graphs:
            self.graphs[key] = self._capture(self._probed(body), generators)
        self.replay(variant, generators)

    def _probed(self, body: Callable) -> Callable:
        """``body``, bracketed by the program's begin and end probes
        while tracing is on."""
        if not profiling.on():
            return body
        begin, end = f"{self.name}.begin", f"{self.name}.end"

        def probed(b, gens):
            profiling.probe(begin, self.device)
            body(b, gens)
            profiling.probe(end, self.device)

        return probed

    def replay(self, variant, generators=()) -> None:
        """One replay of the captured ``variant`` (``run`` captures it):
        what the host issues per run, and nothing else."""
        with profiling.span("graphs.replay"):
            profiling.count("graphs.replays")
            self._bind(generators)
            shared = _POOLS.get((self.pool, self.device))
            stream = torch.cuda.current_stream(self.device)
            if shared is not None:
                shared.order(stream)
            self.graphs[(variant, profiling.on())].graph.replay()
            if shared is not None:
                shared.replayed(stream)
            for g, p in zip(generators, self.generators):
                g.set_state(p.get_state())

    def drop_traced(self) -> None:
        """Forget the graphs captured while tracing was on."""
        for key in [k for k in self.graphs if k[1]]:
            del self.graphs[key]

    def run_rows(self, variants, body: Callable, in_rows: torch.Tensor,
                 out_rows: torch.Tensor, generators=()) -> None:
        """One run per entry of ``variants`` (``body(variant)`` is that
        variant's body): input row i of ``in_rows`` copied into the
        ``inp`` buffer before run i, the ``out`` buffer into row i of
        ``out_rows`` after it."""
        inp, out = self.buffers["inp"], self.buffers["out"]
        for i, v in enumerate(variants):
            with profiling.span("graphs.copy_in"):
                inp.copy_(in_rows[i])
            self.run(v, body(v), generators)
            with profiling.span("graphs.copy_out"):
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
            with profiling.span("graphs.capture"):
                profiling.count(f"graphs.captures.{self.name}")
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
        names = self.buffers if self.carry == "all" else self.carry
        bufs = [t for t in tree_leaves([self.buffers[k] for k in names])
                if t is not None]
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
        shared = first = None
        if self.pool is not None:
            shared = _POOLS.get((self.pool, self.device))
        else:  # the program's first graph made its pool
            first = next(iter(self.graphs.values()), None)
        handle = (shared.handle if shared is not None else
                  first.graph.pool() if first is not None else None)
        trail = _OpTrail()
        _CAPTURING.append(self.name)
        try:
            with torch.cuda.graph(graph, pool=handle,
                                  capture_error_mode="thread_local"):
                with trail:
                    body(self.buffers, mine)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: the step cannot be captured into a CUDA graph; "
                f"the last op dispatched was {trail.last}: {e}") from e
        finally:
            _CAPTURING.pop()
        grown = torch.cuda.memory_reserved(self.device) - reserved
        if self.pool is not None:
            if shared is None:
                shared = _POOLS[(self.pool, self.device)] = Pool(graph.pool())
            shared.bytes += grown
            shared.graphs += 1
        return Captured(graph, 0.0, grown)


_PROGRAMS: dict = {}


def program(key, make: Callable[[], StepProgram]) -> StepProgram:
    """The cached program for ``key``, made by ``make()`` the first
    time. The key names everything the buffers' layout and the captured
    graphs depend on: the function, its config, one step's shapes and
    dtypes, the device and which draws are injected. Raises during a
    capture (see the module docstring)."""
    if torch.cuda.is_available():
        _refuse_in_capture(key[0])
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = make()
    return prog


def programs() -> list[StepProgram]:
    return list(_PROGRAMS.values())


def drop_traced() -> None:
    """Every program, cached or not, forgets its traced graphs (the
    tracer, as it turns off and before it frees its ring)."""
    for prog in list(_ALL):
        prog.drop_traced()


def pools() -> dict:
    """The shared pools by (name, device)."""
    return dict(_POOLS)


def clear() -> None:
    _PROGRAMS.clear()
    _POOLS.clear()


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


def load_grouped(dst: list, src: list) -> None:
    """Copy each tensor of ``src`` into the same-shaped one of ``dst``
    with one multi-tensor copy per dtype (``torch._foreach_copy_``: one
    launch on the card for same-dtype contiguous tensors): a step's
    inputs in and its outputs out in as few launches as their dtypes
    allow."""
    groups: dict = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(s.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def call_program(name: str, cfg: tuple, inputs: tuple, out: Packing,
                 carry: tuple[str, ...] = (),
                 n_generators: int = 0) -> StepProgram:
    """The program of a function whose call is a few runs of its variants
    (a solver, the bootstrap), keyed by (``name``, ``cfg``, the inputs'
    shapes, None where absent), with ``inputs`` (a tuple of tensors,
    NamedTuples of them and None) copied into its ``inp`` buffers of the
    same structure by one grouped copy per dtype. Its ``out`` buffer is
    one row of ``out``, which the caller copies out in one copy
    (``packed_result``); ``carry`` names the buffers its variants update
    in place; ``n_generators`` as ``StepProgram``'s."""
    dev = next(t for t in tree_leaves(inputs) if t is not None).device

    def make():
        bufs = dict(inp=empty_like_tree(tuple(inputs)),
                    out=out.rows(device=dev))
        return StepProgram(name, bufs, dev, n_generators, carry=carry)

    prog = program((name, cfg, shape_key(inputs)), make)
    given = [(d, s) for d, s in zip(tree_leaves(prog.buffers["inp"]),
                                    tree_leaves(inputs)) if s is not None]
    load_grouped(*map(list, zip(*given)))
    return prog


def packed_result(prog: StepProgram, out: Packing) -> Any:
    """The tree in ``prog``'s ``out`` row, as views of the call's own copy
    of it (one copy): a later call rewrites the buffer, not this."""
    return out.unpack(prog.buffers["out"].clone())


def keep(buffers: dict, name: str, value: Any) -> Any:
    """``value`` (a tensor or a tree of them) written into the program
    buffer ``name``, which its first run makes like it: a variant's
    warm-up on the card, outside any capture. A body hands what a later
    variant reads through such a buffer. Returns the buffer."""
    if name not in buffers:
        if any(t.is_cuda for t in tree_leaves(value)) and (
                torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"program buffer {name!r} first made during "
                               f"a CUDA graph capture")
        buffers[name] = empty_like_tree(value)
    load(buffers[name], value)
    return buffers[name]


def empty_like_tree(tree: Any) -> Any:
    """Fresh tensors of ``tree``'s shapes (a NamedTuple of tensors, or
    one tensor); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    parts = (empty_like_tree(x) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


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
