"""Config for --arch granite-moe-3b-a800m (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("granite-moe-3b-a800m")
