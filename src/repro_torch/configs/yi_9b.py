"""Config for --arch yi-9b (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("yi-9b")
