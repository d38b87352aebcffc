"""The port's hand-written kernels against their plain PyTorch versions on
the card, over the grid and tolerance rule of ``repro_torch.kernels.parity``
(the same grid ``chip_smoke.py`` runs). Every test here needs a CUDA device
and skips without one; the file imports neither JAX nor the reference
package, so it runs on the GPU machine:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.parity import CARD_CASES, check_case, check_scores
from repro_torch.kernels.topk.kernel import topk_scores
from repro_torch.kernels.topk.ref import topk_ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    common.strict_fp32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda_device, name, metric, dtype):
    check_case(name, metric, DTYPES[dtype], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
def test_distance_and_topk_kernels_match_plain_on_card(cuda_device, metric):
    """A serving-width case: 64 queries at a padded width of 384, k = 2048."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(64, 384, generator=g).to(cuda_device)
    db = torch.randn(5000, 384, generator=g).to(cuda_device)
    rs = batched_scores_ref(q, db, metric=metric)
    check_scores(batched_scores(q, db, metric=metric), rs, 384, f"distance/{metric}")
    vals, ids = topk_scores(rs, 2048)
    rvals, rids = topk_ref(rs, 2048)
    assert torch.equal(ids, rids) and torch.equal(vals, rvals)
