"""Hand-written Hopper kernels (``csrc/``) behind PyTorch wrappers, each with
its plain PyTorch version and a launch counter."""
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.streaming.ops import streaming_fused_scan
from repro_torch.kernels.topk.kernel import topk_scores

WRAPPERS = {"streaming_fused_scan": streaming_fused_scan,
            "batched_scores": batched_scores,
            "topk_scores": topk_scores,
            "flash_attention": flash_attention}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    flash_attention.route_launches = dict.fromkeys(flash_attention.route_launches, 0)
