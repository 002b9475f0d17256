"""Registered DONN configurations of the port (plain dict registry)."""
from repro_torch.configs.donn import CONFIGS, get_config

__all__ = ["CONFIGS", "get_config"]
