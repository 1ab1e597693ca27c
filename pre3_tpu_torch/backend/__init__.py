"""Backend pieces on the SLAM path: the floor-plane fit."""
