"""Deployment configurations of the port."""
from repro_torch.configs.udg_serve import CONFIG, UdgServeConfig

__all__ = ["CONFIG", "UdgServeConfig"]
