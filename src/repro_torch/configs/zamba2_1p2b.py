"""Config for --arch zamba2-1.2b (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("zamba2-1.2b")
