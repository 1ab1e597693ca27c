"""Quaternion and SE(3) math on tensors (trailing-axis, batched)."""
