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

Two emulations in plain torch hold what K2's design must keep: its
cluster split (ranks over contiguous column ranges, folded in rank order
with the kernel's merge rule) is exactly the plain matcher; and its
3xTF32 product agrees with the f32 plain matcher wherever the margins
are clear, where a single TF32 pass does not.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K2_MARGIN, matcher_problem
from pre3_tpu.ops.matching import match_descriptors_pallas as jpallas
from pre3_tpu_torch.ops.matching import (
    BIG, K2_RANKS, _best_two, _pairwise_dist2, match_descriptors,
    match_descriptors_auto, match_descriptors_k2,
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


# ---- K2's cluster split, emulated: exact ----

def _merge(b, s, i, b2, s2, i2):
    """The kernel's merge(): the lower distance wins, equal distances keep
    the lower index, the runner-up is min(max(b, b2), s, s2)."""
    take = (b2 < b) | ((b2 == b) & (i2 < i))
    return (torch.minimum(b, b2),
            torch.minimum(torch.maximum(b, b2), torch.minimum(s, s2)),
            torch.where(take, i2, i))


def _split_matcher(d1, d2, valid2, ratio, ranks):
    """Rank r of the cluster walks columns [r·N2/S, (r+1)·N2/S) of the
    masked distances and reports (best, second, idx), or (BIG, BIG, 0)
    when none of its columns is valid (a strict '<' never takes a BIG
    column); rank 0 folds the ranks in order."""
    dist2 = torch.where(valid2[None, :], _pairwise_dist2(d1, d2), BIG)
    n1, n2 = dist2.shape
    big = torch.full((n1,), BIG, dtype=torch.float32)
    b, s, i = big, big, torch.zeros(n1, dtype=torch.int64)
    for r in range(ranks):
        lo, hi = r * n2 // ranks, (r + 1) * n2 // ranks
        if hi == lo:
            continue  # the neutral partial
        ri, rb, rs = _best_two(dist2[:, lo:hi])
        ri = torch.where(rb < BIG, ri + lo, 0)
        b, s, i = _merge(b, s, i, rb, rs, ri)
    return i, b, s, (b * ratio < s) & (b < BIG)


def _split_case(name):
    """(d1, d2, valid2) for the cases the split must get right, with
    N2 = 300 unless the case needs fewer."""
    d1, d2, _, v2 = (torch.as_tensor(a) for a in _descs(24, 300, 121, 9))
    if name == "straddling-tie":  # duplicates across every rank boundary
        for cut in (300 // 3, 300 // 8, 2 * 300 // 8, 7 * 300 // 8):
            d2[cut] = d2[cut - 1]
            v2[cut - 1] = v2[cut] = True
        d1[:4] = d2[[300 // 3 - 1, 300 // 8 - 1, 2 * 300 // 8 - 1,
                     7 * 300 // 8 - 1]]
    elif name == "one-split-valid":  # every valid column in rank 4 of 8
        v2[:] = False
        v2[4 * 300 // 8:5 * 300 // 8] = True
    elif name == "n2-below-ranks":  # fewer columns than ranks
        d2, v2 = d2[:5], torch.ones(5, dtype=torch.bool)
        d1[:2] = d2[:2]
    elif name == "all-invalid":
        v2[:] = False
    return d1, d2, v2


@pytest.mark.parametrize("ranks", [1, 3, K2_RANKS])
@pytest.mark.parametrize("case", ["straddling-tie", "one-split-valid",
                                  "n2-below-ranks", "all-invalid"])
def test_cluster_split_is_the_plain_matcher(case, ranks):
    """Partials over contiguous column ranges, folded in rank order with
    the kernel's merge rule, give exactly the plain matcher's index,
    dist2, second and accepted — ties across a boundary (second == best,
    lower index), a row whose valid columns lie in one rank, ranks with
    no column, no valid column at all."""
    d1, d2, v2 = _split_case(case)
    i, b, s, acc = _split_matcher(d1, d2, v2, 1.3, ranks)
    p = match_descriptors(d1, d2, valid2=v2, ratio=1.3)
    assert torch.equal(i, p.index)
    assert torch.equal(b, p.dist2)
    assert torch.equal(s, p.dist2_second)
    assert torch.equal(acc, p.accepted)
    if case == "straddling-tie":
        assert torch.equal(p.dist2[:4], p.dist2_second[:4])
        assert not p.accepted[:4].any()
    if case == "all-invalid":
        assert (i == 0).all() and (b == np.float32(BIG)).all()


# ---- K2's 3xTF32 product, emulated ----

def _tf32_rna(x):
    """x rounded to tf32's 10 mantissa bits, to nearest with ties away
    from zero (cvt.rna), by integer arithmetic on the f32 bits."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """The top 19 bits of x, as the tensor core reads an f32 register."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_match(d1, d2, valid2, ratio, passes):
    """The matcher with its product on emulated tensor cores: 3 passes
    (hi = rna(x), lo = x − hi read truncated; lo·hi + hi·lo, then hi·hi
    added) as K2 computes it, or 1 pass (hi·hi only)."""
    h1, h2 = _tf32_rna(d1), _tf32_rna(d2)
    g = h1 @ h2.T
    if passes == 3:
        l1, l2 = _tf32_trunc(d1 - h1), _tf32_trunc(d2 - h2)
        g = g + (l1 @ h2.T + h1 @ l2.T)
    n1 = torch.sum(d1 * d1, -1, keepdim=True)
    n2 = torch.sum(d2 * d2, -1, keepdim=True).T
    dist2 = torch.where(valid2[None, :],
                        torch.clamp(n1 + n2 - 2.0 * g, min=0.0), BIG)
    idx, best, second = _best_two(dist2)
    return idx, best, (best * ratio < second) & (best < BIG)


TF32_SHAPES = [(256, 256, 121, 0), (256, 288, 128, 1), (1000, 777, 121, 2)]


def _tf32_vs_plain(n1, n2, d, seed, passes):
    d1, d2, v1, v2 = matcher_problem(n1, n2, d, seed, device="cpu")
    p = match_descriptors(d1, d2, valid2=v2, ratio=1.3)
    idx, best, acc = _tf32_match(d1, d2, v2, 1.3, passes)
    clear = (p.dist2_second - p.dist2) / p.dist2.clamp(min=1e-30) > K2_MARGIN
    ratio_gap = (p.dist2 * 1.3 - p.dist2_second).abs() / (
        p.dist2_second.clamp(min=1e-30))
    sel = clear & (ratio_gap > K2_MARGIN)
    finite = p.dist2 < BIG
    return (int((idx != p.index)[clear].sum()),
            int((acc != p.accepted)[sel].sum()),
            int((acc != p.accepted).sum()),
            float((best - p.dist2)[finite].abs().max()))


@pytest.mark.parametrize("n1,n2,d,seed", TF32_SHAPES)
def test_3xtf32_matches_f32_on_clear_rows(n1, n2, d, seed):
    """K2's 3xTF32 product keeps the f32 matcher's index on every row
    whose relative best/second margin exceeds K2_MARGIN, its accepted
    flag where the ratio margin does too, and dist2 within
    1e-5·max‖d‖² (unit descriptors: 1e-5) — chip_smoke.py's problems and
    rules."""
    idx_bad, acc_bad, _, err = _tf32_vs_plain(n1, n2, d, seed, passes=3)
    assert idx_bad == 0 and acc_bad == 0 and err <= 1e-5


@pytest.mark.parametrize("n1,n2,d,seed", TF32_SHAPES)
def test_single_pass_tf32_flips_accepted_matches(n1, n2, d, seed, capsys):
    """A single TF32 pass, which the reference allows at this call site:
    the index and accepted flips against the f32 matcher and its dist2
    error are printed (PERF.md records them); it flips no fewer accepted
    flags than 3xTF32, and its dist2 error is larger."""
    one = _tf32_vs_plain(n1, n2, d, seed, passes=1)
    three = _tf32_vs_plain(n1, n2, d, seed, passes=3)
    with capsys.disabled():
        print(f"\n{n1}x{n2}x{d}: 1xTF32 index flips on clear rows "
              f"{one[0]}, accepted flips on clear rows {one[1]}, on all "
              f"rows {one[2]}, max |dist2 err| {one[3]:.3e}; 3xTF32 "
              f"{three[0]}, {three[1]}, {three[2]}, {three[3]:.3e}")
    assert one[2] >= three[2] and one[3] > three[3]


@pytest.mark.parametrize("tool,argv", [("compare_kernels", ["versions"]),
                                       ("mma_probe", None)])
def test_chip_measurement_tools_stop_without_a_card(tool, argv, monkeypatch):
    """The tools that time kernels on the card stop with a message where
    there is no CUDA device; they never report a CPU number."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"pre3_tpu_torch.utils.{tool}").main
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main() if argv is None else main(argv)
