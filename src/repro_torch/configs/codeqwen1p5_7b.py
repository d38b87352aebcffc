"""Config for --arch codeqwen1.5-7b (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("codeqwen1.5-7b")
