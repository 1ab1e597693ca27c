"""The yardstick of the kernels: published peaks of one NVIDIA H100 SXM
at 700 W, and the operations and bytes of each launch of K1
(``csrc/ransac_score.cu``) and K2 (``csrc/match_stream.cu``) from its
shape (the counts of chip_smoke.py's ``k1_bound``/``k2_bound``).

A kernel's roofline share is Σ bound ÷ Σ measured time over its
launches, where a launch's bound is the larger of its operations over
the peak rate for their type and its bytes (each input read once, each
output written once) over the memory rate.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12  # dense, tensor cores

# substrings of the kernels' names in a profiler trace
KERNELS = {"k1": "ransac_score_kernel", "k2": "match_stream_kernel"}


def bound_s(flops: float, flop_rate: float, nbytes: float):
    """(least seconds, what bounds it: "operations" or "bytes")."""
    t_ops, t_bytes = flops / flop_rate, nbytes / BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_bound(b: int, n: int, s: int = 1):
    """K1 at B hypotheses × N points (s sequences): ~28 f32 flops per
    (hypothesis, point) — 9 products, 9 sums and 3 differences for
    R·p2 + t − p1, 3 squares and 2 sums, the compare and the
    accumulation; bytes: R, t, both point sets, the flags, the
    threshold, support and error."""
    return bound_s(28.0 * s * b * n, F32_FLOPS,
                   s * (b * 48 + 2 * n * 12 + n + 4 + b * 8))


def k2_bound(n1: int, n2: int, d: int, s: int = 1):
    """K2 at N1 × N2 rows of D (s sequences): 2·N1·N2·D flops at the TF32
    tensor-core rate, the fastest the card runs f32 inputs; bytes: both
    descriptor sets, the column flags and the three outputs."""
    return bound_s(2.0 * s * n1 * n2 * d, TF32_FLOPS,
                   s * (4 * (n1 + n2) * d + n2 + n1 * 16))


def step_launches(config: dict, n_feats: int, desc_dim: int, s: int = 1):
    """{kernel: [bound of each launch one SLAM step makes]}: K1 scores the
    VO RANSAC (vo_batch × the frame's features); K2 matches the VO pair
    and, with the descriptor matcher, the map (K × the frame's
    features)."""
    slam = config["slam"]
    vo_batch = slam.get("vo_batch", 512)
    k = config["n_landmarks"]
    k2 = [k2_bound(n_feats, n_feats, desc_dim, s)]
    if slam.get("matcher", "desc") == "desc":
        k2.append(k2_bound(k, n_feats, desc_dim, s))
    return {"k1": [k1_bound(vo_batch, n_feats, s)], "k2": k2}
