"""The matcher of kernel K2 (ops/matching.py) vs the reference's streaming
Pallas matcher, run in interpret mode on the CPU.

K2 itself (csrc/match_stream.cu) runs only on the card; chip_smoke.py
holds it against the plain version there. Here the plain version — K2's
oracle and the CPU path of its wrapper — is held against JAX's
``match_descriptors_pallas(..., interpret=True)`` (the TPU kernel's own
semantics) on the shapes and corner cases K2 must get right: the main
path's shapes, ragged sizes, 1×1, a duplicate-column tie, all-invalid
columns. And the dispatch: on the CPU, and with a ``pair_mask``,
``match_descriptors_auto`` takes the plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.ops.matching import match_descriptors_pallas as jpallas
from pre3_tpu_torch.ops.matching import (
    BIG, match_descriptors, match_descriptors_auto, match_descriptors_k2,
)

# (name, N1, N2, D, seed): the EKF step (map 256 × frame 256 at D = 121),
# SIFT width, a ragged case, the smallest case
CASES = [
    ("step-256x256-d121", 256, 256, 121, 0),
    ("sift-96x288-d128", 96, 288, 128, 1),
    ("ragged-37x141-d121", 37, 141, 121, 2),
    ("one-1x1-d8", 1, 1, 8, 3),
]


def _descs(n1, n2, d, seed, match_frac=0.6):
    """Unit-norm descriptors; a fraction of d1's rows are noisy copies of
    d2 rows, so the ratio test accepts some and rejects others."""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(n2, d)).astype(np.float32)
    d1 = rng.normal(size=(n1, d)).astype(np.float32)
    k = int(match_frac * min(n1, n2))
    src = rng.permutation(n2)[:k]
    d1[:k] = d2[src] + rng.normal(scale=0.3, size=(k, d))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    valid1 = rng.uniform(size=n1) > 0.1
    valid2 = rng.uniform(size=n2) > 0.1
    return d1, d2, valid1, valid2


def _pallas(d1, d2, valid1, valid2, ratio):
    return jpallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid1),
                   jnp.asarray(valid2), ratio=ratio, tile_n1=32,
                   tile_n2=128, interpret=True)


@pytest.mark.parametrize("name,n1,n2,d,seed", CASES)
def test_plain_matches_pallas_interpret(name, n1, n2, d, seed):
    """index equal on every row whose relative margin (second − best) /
    best exceeds 1e-5; accepted equal on those rows when the ratio
    margin is as large; dist2 and dist2_second within 1e-5·max‖d‖²
    (unit descriptors: 1e-5 absolute)."""
    d1, d2, valid1, valid2 = _descs(n1, n2, d, seed)
    ref = _pallas(d1, d2, valid1, valid2, ratio=1.3)
    got = match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2),
                            torch.as_tensor(valid1), torch.as_tensor(valid2),
                            ratio=1.3)
    best, second = np.asarray(ref.dist2), np.asarray(ref.dist2_second)
    clear = (second - best) > 1e-5 * np.maximum(best, 1e-30)
    ratio_clear = np.abs(best * 1.3 - second) > 1e-5 * np.maximum(second,
                                                                   1e-30)
    np.testing.assert_array_equal(got.index.numpy()[clear],
                                  np.asarray(ref.index)[clear])
    sel = clear & ratio_clear
    np.testing.assert_array_equal(got.accepted.numpy()[sel],
                                  np.asarray(ref.accepted)[sel])
    np.testing.assert_allclose(got.dist2.numpy(), best, atol=1e-5)
    np.testing.assert_allclose(got.dist2_second.numpy(), second, atol=1e-5)
    if n2 > 1:
        assert got.accepted.any() and not got.accepted.all()


def test_duplicate_column_tie_is_rejected_and_lowest_index_wins():
    """Two identical columns: second == best exactly, the row is
    rejected, and the lower column index is reported — in the plain
    version as in the Pallas kernel, across a tile boundary too."""
    rng = np.random.default_rng(5)
    d2 = rng.normal(size=(300, 16)).astype(np.float32)
    d1 = d2[[7, 40, 250]].copy()
    d2[200] = d2[7]  # tie across K2/Pallas tiles
    d2[41] = d2[40]  # tie inside a tile
    ones1, ones2 = np.ones(3, bool), np.ones(300, bool)
    ref = _pallas(d1, d2, ones1, ones2, ratio=1.5)
    got = match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2),
                            ratio=1.5)
    for m in (ref, got):
        np.testing.assert_array_equal(np.asarray(m.index), [7, 40, 250])
        np.testing.assert_array_equal(np.asarray(m.accepted),
                                      [False, False, True])
        np.testing.assert_array_equal(np.asarray(m.dist2)[:2],
                                      np.asarray(m.dist2_second)[:2])


def test_all_invalid_columns():
    """No valid column: best = second = BIG (f32), index 0, nothing
    accepted — exactly, in both."""
    d1, d2, valid1, _ = _descs(20, 50, 121, 6)
    none2 = np.zeros(50, bool)
    ref = _pallas(d1, d2, valid1, none2, ratio=1.3)
    got = match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2),
                            torch.as_tensor(valid1), torch.as_tensor(none2),
                            ratio=1.3)
    big = np.float32(BIG)
    for m in (ref, got):
        assert (np.asarray(m.index) == 0).all()
        assert (np.asarray(m.dist2) == big).all()
        assert (np.asarray(m.dist2_second) == big).all()
        assert not np.asarray(m.accepted).any()


def test_auto_takes_the_plain_path_on_cpu_and_with_a_pair_mask():
    """On CPU tensors K2's wrapper is the plain version and launches
    nothing; a pair_mask goes to the plain matcher and is honoured."""
    d1, d2, valid1, valid2 = (torch.as_tensor(a)
                              for a in _descs(64, 80, 121, 7))
    before = match_descriptors_k2.launches
    plain = match_descriptors(d1, d2, valid1, valid2, ratio=1.3)
    for got in (match_descriptors_auto(d1, d2, valid1, valid2, ratio=1.3),
                match_descriptors_k2(d1, d2, valid1, valid2, ratio=1.3)):
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    assert match_descriptors_k2.launches == before
    mask = torch.zeros(64, 80, dtype=torch.bool)
    mask[:, :40] = True
    masked = match_descriptors_auto(d1, d2, valid1, valid2, ratio=1.3,
                                    pair_mask=mask)
    ref = match_descriptors(d1, d2, valid1, valid2, ratio=1.3,
                            pair_mask=mask)
    for a, b in zip(masked, ref):
        assert torch.equal(a, b)
    assert (masked.index < 40).all()
    assert match_descriptors_k2.launches == before


def test_k2_wrapper_rejects_what_the_kernel_does_not_take():
    """Shape errors raise before any device work: mismatched widths and
    an empty d2 (the kernel needs N2 ≥ 1)."""
    with pytest.raises(ValueError, match="d1 \\[N1, D\\] and d2"):
        match_descriptors_k2(torch.zeros(3, 8, device="meta"),
                             torch.zeros(4, 9, device="meta"))
    with pytest.raises(ValueError, match="N2 ≥ 1"):
        match_descriptors_k2(torch.zeros(3, 8, device="meta"),
                             torch.zeros(0, 8, device="meta"))
