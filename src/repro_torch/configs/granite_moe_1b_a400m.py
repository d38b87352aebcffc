"""Config for --arch granite-moe-1b-a400m (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("granite-moe-1b-a400m")
