"""Drivers: the online streaming SLAM loop and the stage pipeline."""
