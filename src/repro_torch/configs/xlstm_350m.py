"""Config for --arch xlstm-350m (see all_archs.py for the full spec)."""
from repro_torch.configs.base import get_arch

CONFIG = get_arch("xlstm-350m")
