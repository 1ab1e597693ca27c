"""Data: SR4000 frame type and the synthetic RGB-D scene renderer."""
