"""Card-only tests: the port's CUDA kernels against their plain PyTorch
versions on the same inputs, on the card. Marked ``cuda``; each test checks
for the card itself and skips without one (the CPU suite collects the same
tests on every worker), apart from one test that shows on the CPU what a
limit of the long-sequence tests refuses. Nothing here imports JAX, so on the card's machine
they run with ``python -m pytest tests/test_torch_cuda.py --noconftest``."""
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import _rope2d_tables
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
    fused_attention,
    fused_attention_packed,
    fused_attention_packed_grouped,
    fused_attention_packed_grouped_plain,
    fused_attention_packed_plain,
    fused_attention_packed_q8,
    fused_attention_packed_q8_plain,
    fused_attention_packed_q8s,
    fused_attention_packed_q8s_plain,
    fused_attention_plain,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    _dequant_epilogue,
    int_matmul,
    quant_static,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    q_block_linear,
    q_block_linear_plain,
    q_linear_fused,
    q_linear_fused_plain,
    q_matmul_pre,
    q_matmul_pre_act_q8,
    q_matmul_pre_act_q8_plain,
    rowquant,
    rowquant_plain,
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
    (1, 4000, 4000, 128, 2),  # keys streamed in both types: no S is refused
    # one-key tails of the bf16 kernel's 64-key chunks (and a 65-row, or
    # 1-row, last warpgroup of its 128-row query tiles)
    (2, 577, 500, 1024, 16),  # ViT-L-14-336 with masked keys
    (2, 65, 65, 128, 2),
    (1, 257, 257, 1024, 16),  # ViT-L-14 (224 px)
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


def _rope(grid, cls, d, device):
    """PE's float32 RoPE tables for a grid x grid tower (+ a cls row)."""
    return tuple(torch.from_numpy(t).to(device) for t in _rope2d_tables(grid, d, 10000.0, cls))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid,cls,s_real,w,heads", [
    (2, 7, True, 43, 128, 2),      # S = 50, masked tail
    (2, 24, True, 577, 1024, 16),  # PE-Core-L14-336
    (1, 10, False, 100, 192, 2),   # head dim 96, no cls row
])
def test_packed_attention_rope_kernel_matches_plain(card, dtype, b, grid, cls, s_real, w, heads):
    """K1 with RoPE inside the kernel (each product and the sum rounded to
    the input type, as the plain version and the TPU kernel round them)."""
    s, d = grid * grid + cls, w // heads
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    rope = _rope(grid, cls, d, card)
    before = fused_attention_packed.launches
    got = fused_attention_packed(qkv, heads, d ** -0.5, s_real, rope)
    torch.cuda.synchronize()
    assert fused_attention_packed.launches == before + 1
    ref = fused_attention_packed_plain(qkv, heads, d ** -0.5, s_real, rope)
    err = (got.float() - ref.float())[:, :s_real].abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid,cls,s_real,w,heads,rope", [
    (2, 7, True, 43, 128, 2, False),      # S = 50, masked tail
    (2, 7, True, 43, 128, 2, True),
    (2, 24, True, 577, 1024, 16, False),  # ViT-L-14-336 (its float32 route)
    (2, 24, True, 577, 1024, 16, True),   # PE-Core-L14-336 (its float32 route)
    (1, 32, False, 1024, 1536, 16, True),  # PE-Core-G14-448: S = 1024, head dim 96
    (1, 32, False, 1000, 1536, 16, True),
    (1, 10, False, 100, 128, 1, False),   # head dim 128
    (1, 66, False, 4356, 128, 2, False),  # past K1's float32 shared-memory limit
    # every padded head dim, S below and off the bf16 kernel's 64-key chunk,
    # s_real < S, with RoPE (in bf16 its pre-pass) and without
    (2, 6, True, 30, 128, 2, False),      # S = 37, head dim 64
    (2, 10, False, 90, 144, 2, False),    # head dim 72 (padded to 80)
    (1, 14, True, 170, 192, 2, False),    # S = 197, head dim 96
    (1, 17, True, 260, 256, 2, False),    # S = 290, head dim 128
    (1, 8, True, 60, 128, 2, True),       # S = 65, head dim 64
    (1, 10, False, 90, 192, 2, True),     # head dim 96
    (1, 7, False, 45, 256, 2, True),      # S = 49, head dim 128
])
def test_grouped_attention_kernel_matches_plain(card, dtype, b, grid, cls, s_real, w, heads,
                                                rope):
    """K4 against its plain version: both types, RoPE on and off, ragged
    s_real, and sequences no whole-row kernel can hold; one K4 launch each
    (the bf16 RoPE pre-pass is part of it)."""
    s, d = grid * grid + cls, w // heads
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    tables = _rope(grid, cls, d, card) if rope else None
    before = fused_attention_packed_grouped.launches
    got = fused_attention_packed_grouped(qkv, heads, d ** -0.5, s_real, tables)
    torch.cuda.synchronize()
    assert fused_attention_packed_grouped.launches == before + 1
    ref = fused_attention_packed_grouped_plain(qkv, heads, d ** -0.5, s_real, tables)
    err = (got.float() - ref.float())[:, :s_real].abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


def test_grouped_wrapper_refuses_bad_inputs(card):
    with pytest.raises(ValueError):  # not contiguous
        fused_attention_packed_grouped(torch.zeros((1, 8, 6 * 128), device=card)[..., ::2], 2,
                                       0.1)
    with pytest.raises(ValueError):  # float16 is not a K4 dtype
        fused_attention_packed_grouped(
            torch.zeros((1, 8, 3 * 128), device=card, dtype=torch.float16), 2, 0.1)
    with pytest.raises(ValueError):  # head dim 136 is over 128
        fused_attention_packed_grouped(torch.zeros((1, 8, 3 * 272), device=card), 2, 0.1)
    bf = torch.zeros((1, 4, 3 * 96), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 RoPE pairs 16-byte vectors: head dim 24 % 16
        fused_attention_packed_grouped(bf, 4, 0.1, rope=_rope(2, False, 24, card))
    with pytest.raises(ValueError):  # tables of the wrong length
        fused_attention_packed_grouped(bf.float(), 1, 0.1, rope=_rope(3, False, 96, card))
    with pytest.raises(ValueError):  # s_real past S
        fused_attention_packed_grouped(bf, 1, 0.1, s_real=9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(18, 128), (577, 1024), (300, 4096),
                                 # SO400M-384's rows (two warps a row); rows of 8 bf16 or
                                 # 4 f32 values short of a 16-byte vector, and past the
                                 # registers: the staged kernel
                                 (301, 1152), (65, 1001), (9, 10240)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 17, 17, 128, 2),  # one 24-key panel
    (2, 50, 43, 144, 2),  # head dim 72, masked tail
    (2, 729, 729, 1152, 16),  # ViT-SO400M-14-SigLIP-384: two 368-key panels
    (1, 1100, 1000, 256, 2),  # three 368-key panels, the last partly masked
    (1, 729, 700, 128, 2),    # head dim 64: the panels end inside a 32-key chunk
    (1, 1100, 1000, 512, 4),  # head dim 128
    (1, 4001, 4001, 128, 2),  # sixteen 256-key panels
])
def test_flash_attention_kernel_matches_plain(card, dtype, b, s, s_real, w, heads):
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    before = (flash_attention_packed.launches, flash_attention_packed.rope_launches)
    got = flash_attention_packed(qkv, heads, (w // heads) ** -0.5, s_real)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches,
            flash_attention_packed.rope_launches) == (before[0] + 1, before[1])
    ref = flash_attention_packed_plain(qkv, heads, (w // heads) ** -0.5, s_real)
    err = (got.float() - ref.float())[:, :s_real].abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


def _q8s_inputs(b, s, w, seed, device):
    """int8 qkv and folded channel scales that give scores of std ~3 and
    outputs over much of the int8 range."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.integers(-127, 128, (b, s, 3 * w), dtype=np.int8))
    cs = np.concatenate([rng.uniform(0.5, 1.5, 2 * w) * 8e-3,
                         rng.uniform(0.5, 1.5, w) * 0.5]).astype(np.float32)
    return qkv.to(device), torch.from_numpy(cs).to(device)


# the edges of the shared wgmma template that the int8 wires meet: head dims
# 96 and 128 (one block an SM at 128), S < 64 (one chunk), s_real = 1, a last
# query tile whose second warpgroup lies wholly past S (190 = 128 + 62), and
# three heads of 72 over B = 3 (head slices that start 8 bytes off 16)
Q8_EDGES = [(1, 200, 200, 192, 2), (1, 130, 130, 256, 2), (2, 40, 40, 144, 2),
            (1, 33, 1, 128, 2), (2, 190, 170, 144, 2), (3, 100, 100, 216, 3)]


@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 50, 43, 144, 2), (2, 729, 729, 1152, 16), (1, 300, 300, 1024, 16), *Q8_EDGES,
])
def test_q8s_attention_kernel_matches_plain(card, b, s, s_real, w, heads):
    qkv, cs = _q8s_inputs(b, s, w, seed=s, device=card)
    before = fused_attention_packed_q8s.launches
    got = fused_attention_packed_q8s(qkv, cs, heads, s_real)
    torch.cuda.synchronize()
    assert fused_attention_packed_q8s.launches == before + 1
    ref = fused_attention_packed_q8s_plain(qkv, cs, heads, s_real)
    diff = (got.int() - ref.int())[:, :s_real].abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3
    assert ref.abs().float().mean().item() > 5  # the outputs use the int8 range


def test_wrappers_refuse_bad_inputs(card):
    qkv = torch.zeros((1, 8, 6 * 128), device=card)[..., ::2]  # not contiguous
    with pytest.raises(ValueError):
        fused_attention_packed(qkv, 2, 0.125)
    with pytest.raises(ValueError):  # bfloat16 needs head dim % 8 == 0
        fused_attention_packed(torch.zeros((1, 8, 3 * 36), device=card, dtype=torch.bfloat16),
                               3, 0.125)
    with pytest.raises(ValueError):  # float16 is not a flash dtype
        flash_attention_packed(torch.zeros((1, 8, 3 * 128), device=card, dtype=torch.float16),
                               2, 0.125)
    q8 = torch.zeros((1, 8, 3 * 128), device=card, dtype=torch.int8)
    with pytest.raises(ValueError):  # channel scales of the wrong length
        fused_attention_packed_q8s(q8, torch.ones(128, device=card), 2)
    with pytest.raises(ValueError):  # head dim 12 is not a multiple of 8
        fused_attention_packed_q8s(torch.zeros((1, 8, 3 * 36), device=card, dtype=torch.int8),
                                   torch.ones(108, device=card), 3)
    x = torch.zeros((4, 128), device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        rowquant_static(x, torch.ones(128, device=card), torch.zeros(128, device=card),
                        torch.ones(1, device=card))


@pytest.mark.parametrize("mode,kernel", [
    ("int8_static", fused_attention_packed),  # K1 with RoPE, K2
    ("bfloat16", fused_attention_packed),
    ("float32", fused_attention_packed_grouped),  # K4 with RoPE
])
def test_pe_l14_two_layers_on_card_matches_cpu(card, mode, kernel):
    """PE-Core-L14-336 cut to 2 layers (S=577, w=1024, 16 heads of 64, RoPE,
    attention pool): the tower on the card against the same weights,
    calibration and images on the CPU (the plain versions)."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config("PE-Core-L14-336"), layers=2)
    params = vit.init_vit_params(cfg, torch.Generator().manual_seed(0))
    images = _normal((2, 336, 336, 3), seed=4)
    if mode == "int8_static":
        params = quantize_vit_params(params)
    cpu = module_from_params(params, cfg)
    gpu = module_from_params(params, cfg, card)
    if mode == "int8_static":
        amax = vit.vit_act_amax(cpu, images)
        for m in (cpu, gpu):
            vit.attach_act_amax(m, amax)
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    before = kernel.launches
    got = vit.vit_encode_image(gpu, images.to(card), dtype).cpu().numpy()
    assert kernel.launches == before + cfg.layers
    ref = vit.vit_encode_image(cpu, images, dtype).numpy()
    limit = {"int8_static": 2e-3, "bfloat16": 1e-3, "float32": 1e-5}[mode]
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= limit


def test_vit_l14_two_layers_float32_on_card_matches_cpu(card):
    """ViT-L-14 (224 px) cut to 2 layers in float32 (S=257, w=1024, 16 heads
    of 64): its block fits the JAX whole-block gate, so K1's float32 kernel
    runs each layer, against the same weights and images on the CPU."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.attention import fused_attention_packed_grouped

    cfg = dataclasses.replace(vit.resolve_config("ViT-L-14/openai"), layers=2)
    params = vit.init_vit_params(cfg, torch.Generator().manual_seed(0))
    images = _normal((2, 224, 224, 3), seed=7)
    cpu = module_from_params(params, cfg)
    gpu = module_from_params(params, cfg, card)
    before = fused_attention_packed.launches, fused_attention_packed_grouped.launches
    got = vit.vit_encode_image(gpu, images.to(card), torch.float32).cpu().numpy()
    assert (fused_attention_packed.launches - before[0],
            fused_attention_packed_grouped.launches - before[1]) == (cfg.layers, 0)
    ref = vit.vit_encode_image(cpu, images, torch.float32).numpy()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 1e-5


@pytest.mark.parametrize("mode", ["int8_static", "bfloat16"])
def test_so400m_two_layers_on_card_matches_cpu(card, mode):
    """ViT-SO400M-14-SigLIP-384 cut to 2 layers (S=729, w=1152, 16 heads of
    72): the tower on the card (K3 through the int8 wire, or K5, as the
    routing picks for this shape) against the same weights, calibration and
    images on the CPU (the plain versions)."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.attention import attention_route
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config("ViT-SO400M-14-SigLIP-384/webli"), layers=2)
    assert attention_route(cfg.seq_len, cfg.width, cfg.heads, 2) == "flash"
    params = vit.init_vit_params(cfg, torch.Generator().manual_seed(0))
    images = _normal((2, 384, 384, 3), seed=3)
    if mode == "int8_static":
        params = quantize_vit_params(params)
    cpu = module_from_params(params, cfg)
    gpu = module_from_params(params, cfg, card)
    if mode == "int8_static":
        amax = vit.vit_act_amax(cpu, images)
        for m in (cpu, gpu):
            vit.attach_act_amax(m, amax, wire=True)
    kernel = flash_attention_packed if mode == "bfloat16" else fused_attention_packed_q8s
    before = kernel.launches
    got = vit.vit_encode_image(gpu, images.to(card), torch.bfloat16).cpu().numpy()
    assert kernel.launches == before + cfg.layers
    ref = vit.vit_encode_image(cpu, images, torch.bfloat16).numpy()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3


def _flips(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of int8 entries that differ, after checking none differs by more
    than 1."""
    diff = (got.int() - ref.int()).abs()
    assert diff.max().item() <= 1
    return (diff > 0).float().mean().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln,act", [
    (True, None), (False, "quick_gelu"), (False, "gelu_tanh"), (False, "gelu"),
    (True, "gelu"), (False, None),
])
@pytest.mark.parametrize("m,k", [
    (18, 128), (577, 1024), (300, 4096), (5, 72),
    (37, 1152), (11, 4304),  # SO400M-384's widths; M not a multiple of the block's rows
    (9, 1001),               # K not a multiple of the vector width: the staged schedule
    (3, 12288),              # longer than eight warps' registers: the staged schedule
])
def test_rowquant_kernel_matches_plain(card, dtype, ln, act, m, k):
    """K6: int8 ±1 on ≤ 0.1% of entries, row scales within rtol 1e-6."""
    x = (_normal((m, k), seed=k) * 2).to(card, dtype)
    g = (1 + 0.1 * _normal((k,), seed=1)).to(card) if ln else None
    bta = (0.1 * _normal((k,), seed=2)).to(card) if ln else None
    before = rowquant.launches
    q, s = rowquant(x, g, bta, act=act)
    torch.cuda.synchronize()
    assert rowquant.launches == before + 1
    rq, rs = rowquant_plain(x, g, bta, act=act)
    assert _flips(q, rq) <= 1e-3
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("m,k,n,with_bias", [
    (300, 1024, 3072, True), (1000, 4096, 1024, True), (17, 64, 32, False),
    (130, 48, 72, True),   # ragged tiles in M, N and K
    (5, 32, 7, True),      # odd N: scalar stores
])
def test_q_linear_fused_kernel_matches_plain(card, dtype, out_dtype, m, k, n, with_bias):
    """K9: the same int8 product and float32 epilogue; one bf16 (or 1e-6
    float32) relative step apart at most, outside rows where a quantized
    value flipped (none expected: the quantize pass is K6's)."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(card, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(card) if with_bias else None
    before = q_linear_fused.launches
    got = q_linear_fused(x, wq, ws, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert q_linear_fused.launches == before + 1 and got.dtype == out_dtype
    ref = q_linear_fused_plain(x, wq, ws, b, out_dtype=out_dtype)
    rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-6
    bad = ((got.float() - ref.float()).abs() > rel * ref.float().abs() + 1e-6).any(dim=1)
    assert bad.float().mean().item() <= 1e-3, f"{int(bad.sum())} rows off"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (300, 1024, 3072), (1000, 4096, 1024), (130, 48, 72), (5, 32, 7), (17, 64, 32),
    (37, 1152, 4304),
])
def test_no_layernorm_outputs_bit_identical(card, dtype, m, k, n):
    """Without a layernorm or an activation nothing sums in float32: K6's
    int8 rows and scales equal the plain version's bit for bit, and so do
    K9's outputs (the int32 product is exact in any order and the epilogue
    rounds each step as the plain version's passes do)."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(card, dtype)
    q, s = rowquant(x)
    rq, rs = rowquant_plain(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(card)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = q_linear_fused(x, wq, ws, b, out_dtype=out_dtype)
        assert torch.equal(got, q_linear_fused_plain(x, wq, ws, b, out_dtype=out_dtype))


def test_q_linear_fused_refuses_bad_inputs(card):
    x = torch.zeros((4, 40), device=card)
    with pytest.raises(ValueError):  # K % 16 != 0
        q_linear_fused(x, torch.zeros((8, 40), device=card, dtype=torch.int8),
                       torch.ones(8, device=card))
    x = torch.zeros((4, 32), device=card)
    with pytest.raises(ValueError):  # weight of the wrong width
        q_linear_fused(x, torch.zeros((8, 48), device=card, dtype=torch.int8),
                       torch.ones(8, device=card))
    with pytest.raises(ValueError):  # scales of the wrong length
        q_linear_fused(x, torch.zeros((8, 32), device=card, dtype=torch.int8),
                       torch.ones(4, device=card))
    with pytest.raises(ValueError):  # unknown activation
        rowquant(x, act="relu")


def _pre_operands(m, k, n, out_dtype, with_res, scale, device, seed):
    """A ``q_matmul_pre`` call's operands on ``device``: int8 rows, a 0-d
    (``scale`` "tensor") or [M, 1] ("rows") float32 x_scale, int8 weights
    [N, K], float32 scales and bias, and a bf16 residual."""
    rng = np.random.default_rng(seed)
    xs = (torch.tensor(np.float32(rng.uniform(0.01, 0.05))) if scale == "tensor"
          else torch.from_numpy(rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)))
    res = (torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(torch.bfloat16)
           if with_res else None)
    ops = dict(xq=torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)), x_scale=xs,
               wq_t=torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)),
               w_scale=torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)),
               bias=torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)), residual=res)
    return {**{k_: None if v is None else v.to(device) for k_, v in ops.items()},
            "out_dtype": out_dtype}


def _torch_route(ops):
    """``q_matmul_pre``'s torch route: ``torch._int_mm`` and the epilogue's passes."""
    return _dequant_epilogue(int_matmul(ops["xq"], ops["wq_t"]), ops["x_scale"], ops["w_scale"],
                             ops["bias"], ops["residual"], ops["out_dtype"])


@pytest.mark.parametrize("scale", ["tensor", "rows"])
@pytest.mark.parametrize("m", [18464, 577, 17])
@pytest.mark.parametrize("k,n,out_dtype,with_res", [
    # ViT-L-14-336 (lnk): qkv, out, fc1, fc2 with its residual
    (1024, 3072, torch.bfloat16, False), (1024, 1024, torch.bfloat16, False),
    (1024, 4096, torch.bfloat16, False), (4096, 1024, torch.bfloat16, True),
    # SO400M-384 (wire): qkv to float32, out, fc1, fc2 with its residual
    (1152, 3456, torch.float32, False), (1152, 1152, torch.bfloat16, False),
    (1152, 4304, torch.bfloat16, False), (4304, 1152, torch.bfloat16, True),
])
def test_q_matmul_pre_gemm_bit_identical_to_torch_route(card, k, n, out_dtype, with_res, m,
                                                        scale):
    """``q_matmul_pre`` on K9's GEMM at the benchmarked towers' products
    (M = 18464 rows, one image's 577 and a ragged 17), with a per-tensor
    x_scale read on the card or [M, 1] row scales: one launch and the torch
    route's bits."""
    ops = _pre_operands(m, k, n, out_dtype, with_res, scale, card, seed=m + k + n)
    before = q_matmul_pre.launches
    got = q_matmul_pre(**ops)
    torch.cuda.synchronize()
    assert q_matmul_pre.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, _torch_route(ops))


@pytest.mark.parametrize("change", ["k40", "float16_out", "x_scale_float64", "bias_bf16",
                                    "x_scale_m"])
def test_q_matmul_pre_refuses_what_the_gemm_does_not_take(card, change):
    """On the card ``q_matmul_pre`` is K9's GEMM alone: an input the GEMM
    does not take (K % 16, a float16 output, a float64 or [M] x_scale, a
    bf16 bias) raises ValueError and launches nothing."""
    ops = _pre_operands(577, 40 if change == "k40" else 1024, 1024, torch.bfloat16, True,
                        "tensor", card, seed=5)
    if change == "float16_out":
        ops["out_dtype"] = torch.float16
    elif change == "x_scale_float64":
        ops["x_scale"] = ops["x_scale"].double()
    elif change == "bias_bf16":
        ops["bias"] = ops["bias"].to(torch.bfloat16)
    elif change == "x_scale_m":
        ops["x_scale"] = ops["x_scale"].reshape(1).expand(577).contiguous()
    before = q_matmul_pre.launches
    with pytest.raises(ValueError, match="q_matmul_pre"):
        q_matmul_pre(**ops)
    assert q_matmul_pre.launches == before


def _chain_hidden(xq, x_scale, wq_t, w_scale, bias, act, out_amax):
    """The chain ``q_matmul_pre_act_q8`` replaces, on the card: ``q_matmul_pre``'s
    bf16 product (K9's GEMM), ``models/vit._act`` with quantized=True,
    ``quant_static`` under fc2's amax."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import _act

    h = q_matmul_pre(xq, x_scale, wq_t, w_scale, bias)
    return quant_static(_act(h, act, quantized=True), out_amax)


@pytest.mark.parametrize("amax", [3.0, 1e-3, 0.0])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
@pytest.mark.parametrize("m", [1, 17, 130])
def test_hidden_q8_on_every_bf16_bit_identical_to_the_chain(card, m, act, amax):
    """With xq all zeros the bias sets every fc1 output: a bias row of every
    finite bf16 value, so the epilogue gathers every entry of its table
    that the chain can reach, with an amax that clamps little, one that
    clamps most (1e-3) and 0 (the 1e-8 floor): one launch, the int8 of
    ``quant_static(_act(h))`` on the card bit for bit."""
    finite = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    bias = finite[torch.isfinite(finite)].float().to(card)
    n, k = bias.numel(), 64
    rng = np.random.default_rng(m)
    ops = dict(xq=torch.zeros((m, k), dtype=torch.int8, device=card),
               x_scale=torch.tensor(0.02, device=card),
               wq_t=torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card),
               w_scale=torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(card),
               bias=bias)
    out_amax = torch.tensor([amax], device=card)
    assert torch.equal(q_matmul_pre(**ops).float()[-1], bias)  # h is the bias row
    before = q_matmul_pre_act_q8.launches
    got = q_matmul_pre_act_q8(**ops, act=act, out_amax=out_amax)
    torch.cuda.synchronize()
    assert q_matmul_pre_act_q8.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (m, n)
    assert torch.equal(got, _chain_hidden(**ops, act=act, out_amax=out_amax))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
@pytest.mark.parametrize("m,scale", [(18464, "tensor"), (577, "tensor"), (37, "tensor"),
                                     (2309, "rows")])
@pytest.mark.parametrize("k,n", [(1024, 4096), (1152, 4304)])
def test_hidden_q8_at_the_towers_fc1_bit_identical_to_the_chain(card, k, n, m, scale, act):
    """fc1 at ViT-L-14-336's (1024 → 4096) and SO400M-384's (1152 → 4304)
    shapes on random int8 rows, M ragged, with fc2's amax a little under
    the hidden's max (a few entries clamp): one launch, the chain's bits on
    the card, and those of the plain version (the chain on ``_int_mm``)."""
    ops = _pre_operands(m, k, n, torch.bfloat16, False, scale, card, seed=m + k + n)
    del ops["residual"], ops["out_dtype"]
    from clip_assisted_data_labeling_tpu_torch.models.vit import _act

    g = _act(q_matmul_pre(**ops), act, quantized=True)
    out_amax = (0.9 * g.float().abs().max()).reshape(1)
    before = q_matmul_pre_act_q8.launches
    got = q_matmul_pre_act_q8(**ops, act=act, out_amax=out_amax)
    torch.cuda.synchronize()
    assert q_matmul_pre_act_q8.launches == before + 1
    want = _chain_hidden(**ops, act=act, out_amax=out_amax)
    assert (want.abs() == 127).any() and torch.equal(got, want)
    assert torch.equal(got, q_matmul_pre_act_q8_plain(**ops, act=act, out_amax=out_amax))


@pytest.mark.parametrize("change", ["n40", "act_gelu", "amax_two", "amax_float64", "k40"])
def test_hidden_q8_refuses_what_the_kernel_does_not_take(card, change):
    """On the card ``q_matmul_pre_act_q8`` is the kernel alone: N % 16, the
    erf gelu, an ``out_amax`` of two values or of float64, K % 16 raise
    ValueError and launch nothing (no fallback to the chain)."""
    k, n = (40 if change == "k40" else 1024), (40 if change == "n40" else 1024)
    ops = _pre_operands(577, k, n, torch.bfloat16, False, "tensor", card, seed=6)
    del ops["residual"], ops["out_dtype"]
    ops["act"] = "gelu" if change == "act_gelu" else "gelu_tanh"
    ops["out_amax"] = {"amax_two": torch.tensor([2.0, 3.0], device=card),
                       "amax_float64": torch.tensor([2.0], dtype=torch.float64, device=card)
                       }.get(change, torch.tensor([2.0], device=card))
    before = q_matmul_pre_act_q8.launches
    with pytest.raises(ValueError, match="q_matmul_pre_act_q8"):
        q_matmul_pre_act_q8(**ops)
    assert q_matmul_pre_act_q8.launches == before


@pytest.mark.parametrize("name", ["ViT-L-14-336/openai", "ViT-SO400M-14-SigLIP-384/webli"])
def test_int8_static_towers_with_the_int8_hidden_bit_identical_to_the_chain(card, monkeypatch,
                                                                            name):
    """ViT-L-14-336 (lnk, quick_gelu) and SO400M-384 (the wire, gelu_tanh)
    int8_static cut to 2 layers at full width on the card: the MLP's hidden
    goes through ``q_matmul_pre_act_q8`` once a layer and the other products
    through ``q_matmul_pre`` three times, and the embeddings equal, bit for
    bit, the forward with the chain put back (``_hidden_q8_act`` None)."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config(name), layers=2)
    params = quantize_vit_params(vit.init_vit_params(cfg, torch.Generator().manual_seed(0)))
    images = _normal((4, cfg.image_size, cfg.image_size, 3), seed=8).to(card)
    gpu = module_from_params(params, cfg, card)
    wire = vit.int8_wire_enabled(cfg)
    vit.attach_act_amax(gpu, vit.vit_act_amax(gpu, images), wire=wire)
    assert vit.block_route(gpu.blocks[0], cfg) == ("wire" if wire else "lnk")
    before = q_matmul_pre.launches, q_matmul_pre_act_q8.launches
    got = vit.vit_encode_image(gpu, images, torch.bfloat16)
    torch.cuda.synchronize()
    assert (q_matmul_pre.launches - before[0],
            q_matmul_pre_act_q8.launches - before[1]) == (3 * cfg.layers, cfg.layers)
    monkeypatch.setattr(vit, "_hidden_q8_act", lambda *a: None)
    assert torch.equal(got, vit.vit_encode_image(gpu, images, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 17, 17, 128, 2), (2, 50, 43, 128, 4), (2, 577, 577, 1024, 16),
])
def test_packed_attention_quant_out_matches_plain(card, dtype, b, s, s_real, w, heads):
    """K1 with quant_out: int8 ±1 on ≤ 0.1% of the real tokens' entries,
    per-token scales within rtol 1e-5 (in bf16 on all but ≤ 5% of the tokens,
    which stay within 2^-8: the kernel's scores sum in another order than
    torch's, so a few bf16 P values round to the other neighbour and move
    their token's outputs by up to one bf16 step of that p); one K1 launch
    and no K6 launch."""
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    k1, k6 = fused_attention_packed.launches, rowquant.launches
    q, sc = fused_attention_packed(qkv, heads, (w // heads) ** -0.5, s_real, quant_out=True)
    torch.cuda.synchronize()
    assert (fused_attention_packed.launches, rowquant.launches) == (k1 + 1, k6)
    assert q.dtype == torch.int8 and q.shape == (b, s, w) and sc.shape == (b, s, 1)
    rq, rsc = fused_attention_packed_plain(qkv, heads, (w // heads) ** -0.5, s_real,
                                           quant_out=True)
    assert _flips(q[:, :s_real], rq[:, :s_real]) <= 1e-3
    rel = (sc[:, :s_real] / rsc[:, :s_real] - 1).abs()
    if dtype == torch.float32:
        assert rel.max().item() <= 1e-5
    else:
        assert (rel > 1e-5).float().mean().item() <= 5e-2 and rel.max().item() <= 2.0 ** -8


@pytest.mark.parametrize("mode,fused,counts", [
    ("hybrid", "0", {"K1": 2, "K6": 6, "K9": 0}),
    ("xla", "0", {"K1": 2, "K6": 0, "K9": 0}),
    ("xla-plain", "0", {"K1": 2, "K6": 0, "K9": 0}),
    ("xla-plain", "1", {"K1": 2, "K6": 0, "K9": 8}),
])
def test_vit_l336_two_layers_dynamic_int8_on_card_matches_cpu(card, monkeypatch, mode, fused,
                                                              counts):
    """ViT-L-14-336 cut to 2 layers in dynamic int8, each CTPU_INT8_BLOCK
    route and CTPU_FUSED_QMATMUL: the tower on the card against the same
    weights and images on the CPU (the plain versions), with the launches
    of each kernel."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops import knobs
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config("ViT-L-14-336/openai"), layers=2)
    params = quantize_vit_params(vit.init_vit_params(cfg, torch.Generator().manual_seed(0)))
    images = _normal((2, 336, 336, 3), seed=5)
    cpu = module_from_params(params, cfg)
    gpu = module_from_params(params, cfg, card)
    monkeypatch.setenv("CTPU_INT8_BLOCK", mode)
    monkeypatch.setenv("CTPU_FUSED_QMATMUL", fused)
    knobs.reload()
    try:
        kernels = {"K1": fused_attention_packed, "K6": rowquant, "K9": q_linear_fused}
        before = {k: fn.launches for k, fn in kernels.items()}
        got = vit.vit_encode_image(gpu, images.to(card), torch.bfloat16).cpu().numpy()
        assert {k: fn.launches - before[k] for k, fn in kernels.items()} == counts
        ref = vit.vit_encode_image(cpu, images, torch.bfloat16).numpy()
    finally:
        monkeypatch.undo()
        knobs.reload()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3


# ---- K8, K7, K10 and K5's RoPE option ------------------------------------------

@pytest.mark.parametrize("variant", ["ln", "residual_bf16", "int8_in", "quick_gelu_quant_out",
                                     "gelu_tanh_residual", "ln_gelu_quant_out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 1024, 3072), (1000, 4096, 1024), (130, 128, 256)])
def test_q_block_linear_kernel_matches_plain(card, m, k, n, dtype, variant):
    """K8: the same prologue (K6's pass), int8 product and float32 epilogue
    steps; one K8 launch, no K6 launch. A quantized input value may land on
    the other side of a .5 boundary in K6's pass (its layernorm sums in
    another order than torch's: ±1 on ~1e-6 of the entries, a few rows in a
    thousand at K = 4096), and moves its row's outputs by up to
    amax·w_scale; those rows (≤ 1%) are found from the pass itself. On the
    others: float outputs one bf16 (or 1e-6 float32) relative step apart at
    most; int8 outputs ±1 on ≤ 0.1% of entries with row scales within 1e-6.
    On the flipped rows, tests/test_quant_kernel.py's flip-aware bound:
    1.2·n_flips·amax·w_scale (the 1.2 for the activation's slope) beyond
    that step, and for int8 outputs |q·s − rq·rs| within one output step
    plus that bound."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(card, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(card)
    kw = {"act": {"quick_gelu_quant_out": "quick_gelu", "gelu_tanh_residual": "gelu_tanh",
                  "ln_gelu_quant_out": "gelu"}.get(variant),
          "quant_out": variant.endswith("quant_out"),
          "out_dtype": torch.bfloat16 if variant.endswith("bf16") else torch.float32}
    if variant.startswith("ln"):
        kw["ln_scale"] = (1 + 0.1 * _normal((k,), seed=1)).to(card)
        kw["ln_bias"] = (0.1 * _normal((k,), seed=2)).to(card)
    if "residual" in variant:
        kw["residual"] = _normal((m, n), seed=3).to(card, dtype)
    if variant == "int8_in":
        x, kw["x_scale"] = rowquant_plain(x)
    k8, k6 = q_block_linear.launches, rowquant.launches
    got = q_block_linear(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert (q_block_linear.launches, rowquant.launches) == (k8 + 1, k6)
    ref = q_block_linear_plain(x, wq, ws, b, **kw)
    flip_bound = torch.zeros((m, 1), device=card)
    if variant != "int8_in":
        ln = (kw.get("ln_scale"), kw.get("ln_bias"))
        (xq, _), (rxq, rxs) = rowquant(x, *ln), rowquant_plain(x, *ln)
        n_flips = (xq != rxq).sum(dim=1, keepdim=True)
        flip_bound = 1.2 * n_flips * (rxs * 127) * ws.view(1, -1)
        assert (n_flips > 0).float().mean().item() <= 1e-2, \
            f"{int((n_flips > 0).sum())} input rows flipped"
    ok = (flip_bound == 0).all(dim=1)
    if kw["quant_out"]:
        (q, sc), (rq, rsc) = got, ref
        assert q.dtype == torch.int8 and q.shape == (m, n) and sc.shape == (m, 1)
        assert _flips(q[ok], rq[ok]) <= 1e-3
        torch.testing.assert_close(sc[ok], rsc[ok], rtol=1e-6, atol=0)
        err = (q.float() * sc - rq.float() * rsc).abs()
        assert (err <= torch.maximum(sc, rsc) + flip_bound)[~ok].all().item()
        return
    assert got.dtype == kw["out_dtype"] and got.shape == (m, n)
    rel = 2.0 ** -7 if kw["out_dtype"] == torch.bfloat16 else 1e-6
    bad = ((got.float() - ref.float()).abs() > rel * ref.float().abs() + 1e-6
           + flip_bound).any(dim=1)
    assert not bad.any().item(), f"{int(bad.sum())} rows off ({int((~ok).sum())} flipped)"


def test_q_block_linear_refuses_bad_inputs(card):
    x = torch.zeros((4, 128), device=card)
    wq = torch.zeros((256, 128), device=card, dtype=torch.int8)
    ws = torch.ones(256, device=card)
    with pytest.raises(ValueError, match="K % 128"):  # the TPU kernel's own refusals
        q_block_linear(torch.zeros((4, 96), device=card), wq[:, :96].contiguous(), ws,
                       ln_scale=torch.ones(96, device=card), ln_bias=torch.zeros(96, device=card))
    with pytest.raises(ValueError, match="N % 128"):
        q_block_linear(x, wq[:72].contiguous(), ws[:72].contiguous(), quant_out=True)
    with pytest.raises(ValueError):  # a residual of the wrong shape
        q_block_linear(x, wq, ws, residual=torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError):  # int8 x without its row scales of the right length
        q_block_linear(x.to(torch.int8), wq, ws, x_scale=torch.ones((3, 1), device=card))
    with pytest.raises(ValueError):  # unknown activation
        q_block_linear(x, wq, ws, act="relu")


def _q8_inputs(b, s, w, seed, device):
    """int8 qkv from a per-token quantize and its float32 [B, S, 1] scales,
    with scores of std ~2."""
    qkv = _normal((b, s, 3 * w), seed=seed)
    amax = qkv.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    q = torch.round(qkv / (amax / 127)).clamp(-127, 127).to(torch.int8)
    return q.to(device), (amax / 127 * 1.7).to(device)


@pytest.mark.parametrize("out", ["bfloat16", "float32", "quant_out"])
@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 50, 43, 144, 2), (2, 577, 577, 1024, 16), (1, 729, 729, 1152, 16), *Q8_EDGES,
])
def test_q8_attention_kernel_matches_plain(card, b, s, s_real, w, heads, out):
    """K7: bf16 and float32 outputs within 2e-2 (K1's bf16 tolerance: the
    heads are bf16); quant_out int8 ±1 on ≤ 0.1% of entries and scales as
    K1's quant_out; one K7 launch, no K6 launch."""
    qkv, sc = _q8_inputs(b, s, w, seed=s, device=card)
    kw = {"quant_out": True} if out == "quant_out" else {"out_dtype": getattr(torch, out)}
    k7, k6 = fused_attention_packed_q8.launches, rowquant.launches
    got = fused_attention_packed_q8(qkv, sc, heads, (w // heads) ** -0.5, s_real=s_real, **kw)
    torch.cuda.synchronize()
    assert (fused_attention_packed_q8.launches, rowquant.launches) == (k7 + 1, k6)
    ref = fused_attention_packed_q8_plain(qkv, sc, heads, (w // heads) ** -0.5, s_real=s_real,
                                          **kw)
    if out != "quant_out":
        assert got.dtype == kw["out_dtype"] and got.shape == (b, s, w)
        assert (got.float() - ref.float())[:, :s_real].abs().max().item() <= 2e-2
        return
    (q, qs), (rq, rqs) = got, ref
    assert q.dtype == torch.int8 and q.shape == (b, s, w) and qs.shape == (b, s, 1)
    assert _flips(q[:, :s_real], rq[:, :s_real]) <= 1e-3
    rel = (qs[:, :s_real] / rqs[:, :s_real] - 1).abs()
    assert (rel > 1e-5).float().mean().item() <= 5e-2 and rel.max().item() <= 2.0 ** -8


# ±1 int8 values at long S on at most this share of entries: 3.7x the largest
# share read on the card (1.34e-3, K1 at S=24000; PERF.md), a fifth of what
# quantizing the bf16-rounded output reads (the last test of this section)
LONG_FLIP_SHARE = 5e-3


def _long_quant_out_close(got, ref) -> None:
    """quant_out at a long sequence: every int8 value within ±1, on at most
    LONG_FLIP_SHARE of entries, and every token's scale within 2^-8 (one
    bf16 step of a p). The short-sequence limits (±1 on ≤ 0.1% of entries,
    scales over 1e-5 on ≤ 5% of tokens) are shares that grow with S, because
    more P values round to their other bf16 neighbour (ROADMAP.md, Known
    differences), and are not held here."""
    (q, qs), (rq, rqs) = got, ref
    assert q.dtype == torch.int8 and qs.shape == rqs.shape
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= LONG_FLIP_SHARE
    assert (qs / rqs - 1).abs().max().item() <= 2.0 ** -8


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32, "quant_out"])
def test_q8_attention_kernel_long_sequence(card, out):
    """K7 at S=24000, d=128, past where a block's shared memory could hold
    the batch item's token scales: they come in a chunk at a time, so it
    launches, within test_q8_attention_kernel_matches_plain's limit for bf16
    and float32 outputs, and _long_quant_out_close's for quant_out."""
    b, s, w, heads = 1, 24000, 128, 1
    qkv, sc = _q8_inputs(b, s, w, seed=s, device=card)
    kw = {"quant_out": True} if out == "quant_out" else {"out_dtype": out}
    before = fused_attention_packed_q8.launches
    got = fused_attention_packed_q8(qkv, sc, heads, w ** -0.5, **kw)
    torch.cuda.synchronize()
    assert fused_attention_packed_q8.launches == before + 1
    ref = fused_attention_packed_q8_plain(qkv, sc, heads, w ** -0.5, **kw)
    if out == "quant_out":
        _long_quant_out_close(got, ref)
        return
    assert got.dtype == out and got.shape == (b, s, w)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("s", [8192, 24000])
def test_packed_attention_quant_out_long_sequence(card, s):
    """K1's quant_out at long sequences (one head of 128), within
    _long_quant_out_close's limits."""
    qkv = _normal((1, s, 384), seed=s).to(card, torch.bfloat16)
    got = fused_attention_packed(qkv, 1, 128 ** -0.5, quant_out=True)
    ref = fused_attention_packed_plain(qkv, 1, 128 ** -0.5, quant_out=True)
    _long_quant_out_close(got, ref)


def test_long_quant_out_limits_catch_a_rounding_fault():
    """On the CPU, no card: a row pass that quantizes K1's output after
    rounding it to bf16 keeps every int8 value within ±1 and every scale
    within 2^-8 of quant_out's, so only _long_quant_out_close's share limit
    refuses it; it moves more than ten times LONG_FLIP_SHARE of the values
    at S=2048. The plain version against itself passes."""
    s = 2048
    qkv = _normal((1, s, 384), seed=s).to(torch.bfloat16)
    ref = fused_attention_packed_plain(qkv, 1, 128 ** -0.5, quant_out=True)
    _long_quant_out_close(ref, ref)
    cq, cs = rowquant_plain(fused_attention_packed_plain(qkv, 1, 128 ** -0.5).reshape(s, 128))
    bad = (cq.reshape(1, s, 128), cs.reshape(1, s, 1))
    diff = (bad[0].int() - ref[0].int()).abs()
    assert diff.max().item() <= 1 and (bad[1] / ref[1] - 1).abs().max().item() <= 2.0 ** -8
    assert (diff > 0).float().mean().item() > 10 * LONG_FLIP_SHARE
    with pytest.raises(AssertionError):
        _long_quant_out_close(bad, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d", [(2, 3, 37, 32), (2, 16, 577, 64), (1, 4, 100, 72),
                                     (1, 2, 257, 128)])
def test_unpacked_attention_kernel_matches_plain(card, dtype, b, h, s, d):
    """K10: K1's kernels on [B, h, S, d] read in place; f32 ≤ 1e-5, bf16
    ≤ 2e-2; one K10 launch and no K1 launch."""
    q, k, v = (_normal((b, h, s, d), seed=s + i).to(card, dtype) for i in range(3))
    k10, k1 = fused_attention.launches, fused_attention_packed.launches
    got = fused_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention_packed.launches) == (k10 + 1, k1)
    ref = fused_attention_plain(q, k, v, d ** -0.5)
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


def test_unpacked_attention_refuses_bad_inputs(card):
    q = torch.zeros((1, 2, 8, 64), device=card)
    with pytest.raises(ValueError):  # mixed dtypes
        fused_attention(q, q.bfloat16(), q, 0.125)
    with pytest.raises(ValueError):  # not contiguous
        fused_attention(q.transpose(2, 3), q, q, 0.125)
    with pytest.raises(ValueError):  # bf16 head dim not a multiple of 8
        z = torch.zeros((1, 2, 8, 12), device=card, dtype=torch.bfloat16)
        fused_attention(z, z, z, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid,cls,s_real,w,heads", [
    (2, 7, True, 43, 128, 2),        # S = 50, one panel, masked tail
    (1, 27, False, 729, 128, 2),     # two 368-key panels
    (2, 32, False, 1024, 1536, 16),  # PE-Core-G14-448's shape (d = 96), four 256-key panels
    (1, 30, False, 880, 192, 2),     # S = 900, d = 96: 256-key panels, a short last one
])
def test_flash_attention_rope_kernel_matches_plain(card, dtype, b, grid, cls, s_real, w, heads):
    """K5 with RoPE inside the kernel, each k panel with its own table rows:
    f32 ≤ 1e-5, bf16 ≤ 2e-2; one K5 launch, counted with RoPE too."""
    s, d = grid * grid + cls, w // heads
    qkv = _normal((b, s, 3 * w), seed=s).to(card, dtype)
    rope = _rope(grid, cls, d, card)
    before = (flash_attention_packed.launches, flash_attention_packed.rope_launches)
    got = flash_attention_packed(qkv, heads, d ** -0.5, s_real, rope)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches,
            flash_attention_packed.rope_launches) == (before[0] + 1, before[1] + 1)
    ref = flash_attention_packed_plain(qkv, heads, d ** -0.5, s_real, rope)
    err = (got.float() - ref.float())[:, :s_real].abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err}"


@pytest.mark.parametrize("name,env,counts", [
    ("ViT-L-14-336/openai", {"CTPU_LN_KERNEL": "0"}, {"K1": 2, "K2": 0, "K3": 0, "K5": 0}),
    ("ViT-L-14-336/openai", {"CTPU_INT8_WIRE": "1"}, {"K1": 0, "K2": 0, "K3": 2, "K5": 0}),
    ("ViT-SO400M-14-SigLIP-384/webli", {"CTPU_INT8_WIRE": "0"},
     {"K1": 0, "K2": 4, "K3": 0, "K5": 2}),
])
def test_int8_static_knob_routes_two_layers_on_card_match_cpu(card, monkeypatch, name, env,
                                                              counts):
    """The int8_static routes the knobs pick, on two layers at full width:
    the static generic block (CTPU_LN_KERNEL=0), the wire at S=577
    (CTPU_INT8_WIRE=1) and lnk with K5 at S=729 (CTPU_INT8_WIRE=0), on the
    card against the same weights, calibration and images on the CPU, with
    each kernel's launches."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops import knobs
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config(name), layers=2)
    params = quantize_vit_params(vit.init_vit_params(cfg, torch.Generator().manual_seed(0)))
    images = _normal((2, cfg.image_size, cfg.image_size, 3), seed=6)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    knobs.reload()
    try:
        cpu = module_from_params(params, cfg)
        gpu = module_from_params(params, cfg, card)
        amax = vit.vit_act_amax(cpu, images)
        wire = vit.int8_wire_enabled(cfg)
        for m in (cpu, gpu):
            vit.attach_act_amax(m, amax, wire=wire)
        kernels = {"K1": fused_attention_packed, "K2": rowquant_static,
                   "K3": fused_attention_packed_q8s, "K5": flash_attention_packed}
        before = {k: fn.launches for k, fn in kernels.items()}
        got = vit.vit_encode_image(gpu, images.to(card), torch.bfloat16).cpu().numpy()
        assert {k: fn.launches - before[k] for k, fn in kernels.items()} == counts
        ref = vit.vit_encode_image(cpu, images, torch.bfloat16).numpy()
    finally:
        monkeypatch.undo()
        knobs.reload()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("bfloat16", 1e-3),
                                         ("int8_static", 2e-3)])
@pytest.mark.parametrize("name", ["RN-Test/openai", "CNX-Test-mlp/x"])
def test_conv_towers_on_card_match_cpu(card, name, dtype, limit):
    """The modified-ResNet and ConvNeXt towers on the card (cuDNN
    convolutions with TF32 off; int8_static's 1x1 products on K9's GEMM
    through ``q_matmul_pre``) against the same weights,
    calibration and images on the CPU; no other kernel of the table
    launches."""
    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.models.conv_tower import conv_family
    from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

    resolve_device(card)  # the entry points' TF32 switches
    cfg = vit.resolve_config(name)
    fam = conv_family(cfg)
    params = fam.init(cfg, torch.Generator().manual_seed(3))
    if dtype == "int8_static":
        params = fam.quantize(params)
    cpu, gpu = module_from_params(params, cfg), module_from_params(params, cfg, card)
    images = _normal((4, cfg.image_size, cfg.image_size, 3), seed=7)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    if dtype == "int8_static":
        amax = fam.act_amax(cpu, images)
        for m in (cpu, gpu):
            m.attach_act_amax(amax)
    kernels = (fused_attention_packed, fused_attention_packed_grouped, flash_attention_packed,
               rowquant, rowquant_static, q_linear_fused, fused_attention_packed_q8s)
    before = [fn.launches for fn in kernels]
    pre = q_matmul_pre.launches
    got = fam.encode(gpu, images.to(card), tdtype).cpu().numpy()
    assert [fn.launches for fn in kernels] == before
    assert (q_matmul_pre.launches > pre) == (dtype == "int8_static")
    ref = fam.encode(cpu, images, tdtype).numpy()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= limit


# ---- per-sequence key lengths (the naflex towers' native-aspect rows) ----------

_VARLEN_KERNELS = {"K1": (fused_attention_packed, fused_attention_packed_plain),
                   "K5": (flash_attention_packed, flash_attention_packed_plain)}


@pytest.mark.parametrize("kernel", ["K1", "K5"])
@pytest.mark.parametrize("s,w,heads,lengths", [
    (256, 1152, 16, [256, 1, 200, 129]),     # SO400M/16's crops' length, d = 72
    (1024, 1152, 16, [1024, 1014, 1008, 300, 65]),  # the cell's native rows; K5 skips panels
    (577, 1024, 16, [577, 64, 63, 500]),     # d = 64, chunk edges
    (130, 256, 2, [130, 128, 7]),            # d = 128, a 2-row last query tile
])
def test_varlen_kernel_matches_plain(card, kernel, s, w, heads, lengths):
    """K1 and K5 in bfloat16 given per-sequence lengths: equal to their plain
    versions with the same lengths, zeros (and no NaN) past each length, one
    launch counted in ``launches`` and in ``varlen_launches``."""
    fn, plain = _VARLEN_KERNELS[kernel]
    b = len(lengths)
    qkv = _normal((b, s, 3 * w), seed=s + b).to(card, torch.bfloat16)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = (fn.launches, fn.varlen_launches)
    got = fn(qkv, heads, (w // heads) ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert (fn.launches, fn.varlen_launches) == (before[0] + 1, before[1] + 1)
    assert not torch.isnan(got).any()
    ref = plain(qkv, heads, (w // heads) ** -0.5, kv_len)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], f"max abs err {err}"
    for bi, n in enumerate(lengths):
        assert torch.count_nonzero(got[bi, n:]).item() == 0


@pytest.mark.parametrize("kernel", ["K1", "K5"])
def test_varlen_kernel_equals_each_sequence_alone(card, kernel):
    """A sequence's rows given its length in a batch equal, bit for bit, the
    same kernel without lengths on that sequence alone with s_real = its
    length (the chunks and panels the lengths skip add exact zeros there);
    and lengths that are all S equal the launch without them, bit for bit."""
    fn, _plain = _VARLEN_KERNELS[kernel]
    s, w, heads, lengths = 1024, 1152, 16, [1024, 1014, 1008, 700, 300]
    qkv = _normal((len(lengths), s, 3 * w), seed=23).to(card, torch.bfloat16)
    scale = (w // heads) ** -0.5
    got = fn(qkv, heads, scale, torch.tensor(lengths, dtype=torch.int32, device=card))
    for bi, n in enumerate(lengths):
        alone = fn(qkv[bi: bi + 1].contiguous(), heads, scale, n)
        assert torch.equal(got[bi, :n], alone[0, :n]), (bi, n)
    full = fn(qkv, heads, scale, torch.full((len(lengths),), s, dtype=torch.int32, device=card))
    assert torch.equal(full, fn(qkv, heads, scale))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", ["K1", "K5"])
def test_varlen_float32_runs_each_sequence(card, kernel):
    """float32 with per-sequence lengths: one launch a sequence at its length
    (no varlen launch), equal to the plain version with the lengths."""
    fn, plain = _VARLEN_KERNELS[kernel]
    lengths = [257, 100, 3]
    qkv = _normal((3, 257, 3 * 256), seed=5).to(card)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = (fn.launches, fn.varlen_launches)
    got = fn(qkv, 2, 128 ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert (fn.launches, fn.varlen_launches) == (before[0] + 3, before[1])
    err = (got - plain(qkv, 2, 128 ** -0.5, kv_len)).abs().max().item()
    assert err <= TOL[torch.float32], f"max abs err {err}"


def test_varlen_wrappers_refuse_bad_lengths(card):
    qkv = _normal((2, 64, 3 * 128), seed=1).to(card, torch.bfloat16)
    for bad in (torch.tensor([64, 3], dtype=torch.int64, device=card),
                torch.tensor([64], dtype=torch.int32, device=card),
                torch.tensor([64, 3], dtype=torch.int32)):
        with pytest.raises(ValueError):
            fused_attention_packed(qkv, 2, 0.125, bad)
        with pytest.raises(ValueError):
            flash_attention_packed(qkv, 2, 0.125, bad)
    kv_len = torch.tensor([64, 3], dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_attention_packed(qkv, 2, 0.125, kv_len, quant_out=True)
    with pytest.raises(ValueError):
        fused_attention_packed_grouped(qkv, 2, 0.125, kv_len)


def test_naflex_native_rows_on_the_kernels(card):
    """The native-aspect forward on the card runs its blocks on K1 with
    per-image lengths (the tiny tower's S routes to K1), one varlen launch
    a layer, and agrees with the same route on the CPU's plain kernels."""
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder

    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((40, 40), (48, 72), (30, 90))]
    enc = CLIPImageEncoder("SigLIP2-Naflex-Test/tiny", compute_dtype="float32", device="cuda")
    before = fused_attention_packed.varlen_launches
    got = enc.encode_variable(imgs, max_patches=64).cpu()
    torch.cuda.synchronize()
    assert fused_attention_packed.varlen_launches == before  # float32: one launch a sequence
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import params_from_module

    params = {k: torch.from_numpy(v) for k, v in params_from_module(enc.model).items()}
    cpu = CLIPImageEncoder("SigLIP2-Naflex-Test/tiny", params=params, compute_dtype="float32",
                           device="cpu")
    ref = cpu.encode_variable(imgs, max_patches=64)
    assert (1.0 - (got * ref).sum(-1)).max().item() <= 1e-5
    bf = CLIPImageEncoder("SigLIP2-Naflex-Test/tiny", params=params, compute_dtype="bfloat16",
                          device="cuda")
    before = fused_attention_packed.varlen_launches
    got16 = bf.encode_variable(imgs, max_patches=64).cpu()
    torch.cuda.synchronize()
    assert fused_attention_packed.varlen_launches == before + bf.cfg.layers
    assert (1.0 - (got16 * ref).sum(-1)).max().item() <= 2e-3
