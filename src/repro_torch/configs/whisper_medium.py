"""Config for --arch whisper-medium (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("whisper-medium")
