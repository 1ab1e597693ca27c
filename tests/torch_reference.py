"""What the port's test files share on the reference side: its runs, kept
once per process, and torch's CPU thread count.

``reference(fn, *args, **kwargs)`` runs a JAX reference function and
keeps its result as a numpy tree (read-only arrays), keyed by the
function and by the values of its arguments. Under ``--dist loadfile``
an xdist worker runs many test files, so a later test or file on the
same worker that asks for the same run reads the first one's result;
each file keeps its own inputs and tolerances.

Importing this module runs torch on one CPU thread in this process;
every worker imports it when it collects the port's test files. The
tier-1 command runs six workers, and torch's default of one OpenMP
thread per core in every worker made them contend: on an 8-core host a
SIFT test of 6 s alone took 150 s in the full run, and the whole run
took 1267 s with a warm JAX cache against 452 s at one thread. Every
assertion of the port's tests holds at either count. The port's spawned
CPU ranks already run at one thread (``parallel/dryrun.py``).
"""

import hashlib

import jax
import numpy as np
import torch

torch.set_num_threads(1)

_RUNS: dict = {}


def _key(tree) -> tuple:
    """A hashable stand-in for a tree of arguments: each array leaf by
    its dtype, shape and a digest of its bytes, any other leaf as it
    is."""
    leaves, treedef = jax.tree.flatten(tree)
    out = []
    for leaf in leaves:
        if isinstance(leaf, (np.ndarray, jax.Array)):
            a = np.ascontiguousarray(leaf)
            leaf = (str(a.dtype), a.shape,
                    hashlib.sha1(a.tobytes()).hexdigest())
        out.append(leaf)
    return treedef, tuple(out)


def reference(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a numpy tree, run once per process for
    each function and argument values."""
    key = (fn, _key((args, kwargs)))
    if key not in _RUNS:
        _RUNS[key] = jax.tree.map(np.asarray, fn(*args, **kwargs))
    return _RUNS[key]
