"""Public op for flash attention."""
from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["flash_attention"]
