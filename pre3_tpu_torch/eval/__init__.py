"""Offline trajectory evaluation (ATE / RPE)."""
