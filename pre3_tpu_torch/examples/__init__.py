"""Example drivers of the port: ``python3 -m pre3_tpu_torch.examples.<name>``."""
