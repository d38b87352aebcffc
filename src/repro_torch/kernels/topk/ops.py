"""Public op for the streaming top-k kernel (``csrc/topk.cu``)."""
from repro_torch.kernels.topk.kernel import neg_inf_for, topk_scores

__all__ = ["neg_inf_for", "topk_scores"]
