"""Drivers: the online streaming SLAM loop."""
