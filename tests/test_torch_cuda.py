"""Card-only tests: the port's CUDA kernels against their plain PyTorch
versions on the same inputs, on the card. Marked ``cuda``; each test checks
for the card itself and skips without one (the CPU suite collects the same
tests on every worker). Nothing here imports JAX, so on the card's machine
they run with ``python -m pytest tests/test_torch_cuda.py --noconftest``."""
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    fused_attention_packed,
    fused_attention_packed_plain,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    rowquant_static,
    rowquant_static_plain,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 17, 17, 128, 2), (2, 50, 43, 128, 2), (2, 577, 577, 1024, 16), (1, 257, 200, 1280, 16),
    (1, 130, 130, 1664, 16),  # head dim 104 (ViT-bigG): padded to 112 on the bf16 path
])
def test_packed_attention_kernel_matches_plain(card, dtype, b, s, s_real, w, heads):
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    before = fused_attention_packed.launches
    got = fused_attention_packed(qkv, heads, (w // heads) ** -0.5, s_real)
    torch.cuda.synchronize()
    assert fused_attention_packed.launches == before + 1
    ref = fused_attention_packed_plain(qkv, heads, (w // heads) ** -0.5, s_real)
    err = (got.float() - ref.float())[:, :s_real].abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(18, 128), (577, 1024), (300, 4096)])
def test_rowquant_static_kernel_matches_plain(card, dtype, m, k):
    x = (_normal((m, k), seed=k) * 2).to(card, dtype)
    g = (1 + 0.1 * _normal((k,), seed=1)).to(card)
    bta = (0.1 * _normal((k,), seed=2)).to(card)
    amax = torch.tensor([6.0], device=card)
    before = rowquant_static.launches
    got = rowquant_static(x, g, bta, amax)
    torch.cuda.synchronize()
    assert rowquant_static.launches == before + 1
    diff = (got.int() - rowquant_static_plain(x, g, bta, amax).int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


def test_wrappers_refuse_bad_inputs(card):
    qkv = torch.zeros((1, 8, 6 * 128), device=card)[..., ::2]  # not contiguous
    with pytest.raises(ValueError):
        fused_attention_packed(qkv, 2, 0.125)
    with pytest.raises(ValueError):  # float32 score tile over the shared-memory limit
        fused_attention_packed(torch.zeros((1, 4000, 3 * 128), device=card), 2, 0.125)
    with pytest.raises(ValueError):  # bfloat16 needs head dim % 8 == 0
        fused_attention_packed(torch.zeros((1, 8, 3 * 36), device=card, dtype=torch.bfloat16),
                               3, 0.125)
    x = torch.zeros((4, 128), device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        rowquant_static(x, torch.ones(128, device=card), torch.zeros(128, device=card),
                        torch.ones(1, device=card))
