"""An emulation, in numpy on the CPU, of the schedules of K9's int8 GEMM
(``csrc/q_linear_fused.cu``, which K8 shares) and of the row pass of K6
and K2 (``csrc/rowquant_common.cuh``). The card tests (tests/test_torch_cuda.py) hold the
kernels themselves; this pins what their schedules compute.

The GEMM: a persistent grid of min(tiles, 132) blocks walks 128 x BN output
tiles (BN = 256, or 128 where that leaves at least 10% less work on the
busiest SM) in row-major order, tile t = block + i · grid; each tile sums
128-byte k slices that TMA copies as whole boxes, zero past K, M and N, with
the two consumer warpgroups' 64 rows each; the epilogue masks rows past M
and columns past N and runs ``((f32(acc)·xs)·ws + bias)``, then the
activation and the residual, each step rounded, as
``ops/quant._dequant_epilogue`` and the plain versions do, after a shuffle
among each quad of lanes that gives every lane 8 contiguous columns.

K6's row pass: a group of WPR warps owns a row, lane l holding the row's
vectors l, l + 32·WPR, ... (8 bf16 or 4 float32 values each); each lane sums
its values in that order, the warp adds its lanes by the xor butterfly
(16, 8, 4, 2, 1) and the group adds its warps' totals in warp order; the
variance pass does the same over fmaf(x − mu, x − mu, s). K2 runs the same
pass with a static amax (no floor, no row scales). Against the plain
versions (torch's sums) that order is held at the paths' widths to the card
checks' limits: int8 ±1 on ≤ 0.1% of entries, row scales within 1e-6."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    _dequant_epilogue,
    int_matmul,
    match_k,
    quant_static,
)
from clip_assisted_data_labeling_tpu_torch.ops.activations import SQRT_2_OVER_PI, gelu_tanh, quick_gelu
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    _row_act,
    q_block_linear_plain,
    q_linear_fused_plain,
    _check_hidden_q8,
    _check_pre,
    _hidden_table,
    q_matmul_pre,
    q_matmul_pre_act_q8,
    rowquant_plain,
    rowquant_static_plain,
)

# The schedules' constants are read from the kernels' sources, so the
# emulation follows the kernels
CSRC = Path(__file__).resolve().parents[1] / "clip_assisted_data_labeling_tpu_torch" / "csrc"
_GEMM_SRC = (CSRC / "q_linear_fused.cu").read_text()
# K6's and K2's row pass (rowquant_common.cuh, which both sources launch)
_ROWQUANT_SRC = (CSRC / "rowquant_common.cuh").read_text()


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _GEMM_SRC).group(1))


BM, BK = _constexpr("BM"), _constexpr("BK")  # the GEMM's tile rows and k slice (bytes)
# pick_bn: BN = 128 where PICK_128 · cost(128) <= PICK_256 · cost(256)
PICK_128, PICK_256 = map(int, re.search(
    r"return (\d+) \* cost\(128\) <= (\d+) \* cost\(256\) \? 128 : 256;", _GEMM_SRC).groups())
SMS = 132  # the H100 SXM's SMs (the kernel reads cudaDevAttrMultiProcessorCount)
# the row pass's schedules (warps a row, vectors a lane), in the order it tries them
VEC_SCHEDULES = tuple((int(w), int(n)) for w, n in re.findall(
    r"X\((\d+), (\d+)\)", re.search(r"#define RQ_VEC_SCHEDULES\(X\) (.*)", _ROWQUANT_SRC).group(1)))
FLIP_SHARE = 1e-3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pick_bn(m: int, n: int) -> int:
    """The kernel's tile width: 128 where the busiest SM then has at least
    10% less work (rounds of tiles times BN) than with 256."""
    def cost(bn):
        return _cdiv(_cdiv(m, BM) * _cdiv(n, bn), SMS) * bn
    return 128 if PICK_128 * cost(128) <= PICK_256 * cost(256) else 256


def _emulate_gemm(xq: np.ndarray, wq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's int32 sums [M, N] and how often each output was written:
    every block's tiles, every tile's zero-filled k slices, each consumer's
    64 rows, the epilogue's masks."""
    m, k = xq.shape
    n = wq.shape[0]
    bn = _pick_bn(m, n)
    n_tiles = _cdiv(n, bn)
    tiles = _cdiv(m, BM) * n_tiles
    grid = min(tiles, SMS)
    acc_out = np.zeros((m, n), np.int64)
    written = np.zeros((m, n), np.int64)

    def box(a, r0, rows, k0):  # TMA's box: zero past the tensor's ends
        out = np.zeros((rows, BK), np.int64)
        part = a[r0:r0 + rows, k0:k0 + BK]
        out[:part.shape[0], :part.shape[1]] = part
        return out

    for block in range(grid):
        for tile in range(block, tiles, grid):
            m0, n0 = tile // n_tiles * BM, tile % n_tiles * bn
            acc = np.zeros((BM, bn), np.int64)
            for kt in range(_cdiv(k, BK)):
                a, b = box(xq, m0, BM, kt * BK), box(wq, n0, bn, kt * BK)
                for cw in range(2):  # each consumer warpgroup's 64 rows, k32 at a time
                    for kk in range(BK // 32):
                        acc[64 * cw:64 * cw + 64] += (a[64 * cw:64 * cw + 64, 32 * kk:32 * kk + 32]
                                                      @ b[:, 32 * kk:32 * kk + 32].T)
            assert np.abs(acc).max(initial=0) < 2 ** 31  # the sums fit int32
            rows, cols = min(BM, m - m0), min(bn, n - n0)  # the epilogue's masks
            acc_out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            written[m0:m0 + rows, n0:n0 + cols] += 1
    return acc_out, written


SHAPES = [
    (130, 48, 72), (5, 32, 7), (17, 64, 32),   # the card tests' ragged cases
    (300, 1024, 3072), (257, 4096, 1024),      # ViT-L's products at fewer rows
    (37, 1152, 4304),                          # SO400M-384's fc1
]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_schedule_writes_each_output_once_with_the_exact_product(m, k, n):
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    acc, written = _emulate_gemm(xq, wq)
    assert (written == 1).all()
    np.testing.assert_array_equal(acc, xq.astype(np.int64) @ wq.astype(np.int64).T)
    np.testing.assert_array_equal(
        acc, int_matmul(torch.from_numpy(xq), torch.from_numpy(wq)).numpy())


@pytest.mark.parametrize("m,n,bn", [(9232, 3072, 256), (9232, 1024, 128), (18464, 3072, 256),
                                    (18464, 4096, 256), (18464, 1024, 128), (5, 7, 128)])
def test_gemm_tile_width_at_the_paths_shapes(m, n, bn):
    """The tile width at K9's and K8's path shapes: 128 at N = 1024, else 256."""
    assert _pick_bn(m, n) == bn


def test_quad_transpose_gives_each_lane_eight_contiguous_columns():
    """The epilogue's quad transpose (``quad_transpose``), round by round as
    the kernel runs it: lane t holds column 8·jj + 2t + e of its row before
    (a[jj][e]), and column 8t + 2u + e after (a[u][e])."""
    lanes = np.arange(32)
    t = lanes & 3
    a = np.array([[[8 * jj + 2 * ti + e for e in range(2)] for jj in range(4)] for ti in t])
    b = a.copy()
    for r in (1, 2, 3):
        src, k = (t + r) & 3, (t - r) & 3
        send = a[lanes, k]                 # [32, 2]: this lane's a[k]
        got = send[(lanes & ~3) | src]     # __shfl_sync from lane (lane & ~3) | src
        b[lanes, src] = got
    want = np.array([[[8 * ti + 2 * u + e for e in range(2)] for u in range(4)] for ti in t])
    np.testing.assert_array_equal(b, want)


def _epilogue_f32(acc, xs, ws, bias, act=None, residual=None, xs_stride=1):
    """The kernel's epilogue, one float32 rounding a step (numpy float32
    arithmetic contracts nothing): f32(acc)·xs[m · xs_stride], ·ws[n],
    + bias[n], then the activation (torch's, as the plain version's) and
    + residual."""
    sx = xs.reshape(-1)[np.arange(acc.shape[0]) * xs_stride]  # each row's one read
    y = acc.astype(np.float32) * sx.reshape(-1, 1)
    y = y * ws.reshape(1, -1)
    if bias is not None:
        y = y + bias.reshape(1, -1)
    if act is not None:
        y = _row_act(torch.from_numpy(y), act).numpy()
    if residual is not None:
        y = y + residual
    return y


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", SHAPES[:4])
def test_gemm_epilogue_order_matches_dequant_epilogue(m, k, n, out_dtype):
    """K9: the emulated epilogue on the emulated sums equals, bit for bit,
    ``_dequant_epilogue`` on ``int_matmul`` and ``q_linear_fused_plain``."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    ws = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    xq, xs = rowquant_plain(x)
    acc, _ = _emulate_gemm(xq.numpy(), wq)
    got = torch.from_numpy(_epilogue_f32(acc, xs.numpy(), ws, bias)).to(out_dtype)
    t_wq = torch.from_numpy(wq)
    ref = _dequant_epilogue(int_matmul(xq, t_wq), xs, torch.from_numpy(ws),
                            torch.from_numpy(bias), None, out_dtype)
    assert torch.equal(got, ref)
    assert torch.equal(got, q_linear_fused_plain(x, t_wq, torch.from_numpy(ws),
                                                 torch.from_numpy(bias), out_dtype))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh", "gelu"])
def test_gemm_epilogue_order_with_activation_and_residual(act):
    """K8: the activation after the bias and before the residual, the
    residual added in float32 and the cast last, as ``q_block_linear_plain``."""
    m, k, n = 130, 128, 256
    rng = np.random.default_rng(7)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    xs = rng.uniform(0.01, 0.03, (m, 1)).astype(np.float32)
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    ws = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    res = torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(torch.bfloat16)
    acc, _ = _emulate_gemm(xq, wq)
    got = torch.from_numpy(_epilogue_f32(acc, xs, ws, bias, act, res.float().numpy()))
    ref = q_block_linear_plain(torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(ws),
                               torch.from_numpy(bias), x_scale=torch.from_numpy(xs),
                               residual=res, act=act, out_dtype=torch.float32)
    assert torch.equal(got, ref)


# q_matmul_pre on the card: the GEMM alone over int8_static's rows, with one
# per-tensor x_scale (xs_stride 0) or [M, 1] row scales (1). The cells'
# products at fewer rows: ViT-L-14-336's qkv, out, fc1 and fc2 (bf16 out, the
# fc2 residual bf16), SO400M-384's qkv (float32 out), out, fc1 and fc2.
PRE_PRODUCTS = [
    (130, 1024, 3072, torch.bfloat16, False), (130, 1024, 1024, torch.bfloat16, False),
    (129, 1024, 4096, torch.bfloat16, False), (129, 4096, 1024, torch.bfloat16, True),
    (37, 1152, 3456, torch.float32, False), (17, 1152, 1152, torch.bfloat16, False),
    (37, 1152, 4304, torch.bfloat16, False), (37, 4304, 1152, torch.bfloat16, True),
]


@pytest.mark.parametrize("scale", ["tensor", "rows"])
@pytest.mark.parametrize("m,k,n,out_dtype,with_res", PRE_PRODUCTS)
def test_gemm_epilogue_with_a_per_tensor_scale_matches_dequant_epilogue(m, k, n, out_dtype,
                                                                        with_res, scale):
    """The emulated sums and epilogue with the stride ``_check_pre``
    gives (0 for a 0-d ``x_scale``, every row reading its one element; 1 for
    [M, 1]) equal, bit for bit, ``_dequant_epilogue`` on ``int_matmul`` with
    that ``x_scale`` and ``q_matmul_pre`` (its CPU route)."""
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
    xs = (torch.tensor(np.float32(rng.uniform(0.01, 0.05))) if scale == "tensor"
          else torch.from_numpy(rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)))
    res = (torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(torch.bfloat16)
           if with_res else None)
    t_xq, t_wq = torch.from_numpy(xq), torch.from_numpy(wq)
    stride = _check_pre(t_xq, xs, t_wq, ws, bias, res, out_dtype)
    assert stride == (0 if scale == "tensor" else 1)
    acc, _ = _emulate_gemm(xq, wq)
    got = torch.from_numpy(_epilogue_f32(acc, xs.numpy(), ws.numpy(), bias.numpy(),
                                         residual=None if res is None else res.float().numpy(),
                                         xs_stride=stride)).to(out_dtype)
    ref = _dequant_epilogue(int_matmul(t_xq, t_wq), xs, ws, bias, res, out_dtype)
    assert torch.equal(got, ref)
    assert torch.equal(got, q_matmul_pre(t_xq, xs, t_wq, ws, bias, res, out_dtype))


def _pre_operands(m=33, k=64, n=48):
    """A q_matmul_pre call's operands that K9's GEMM takes (CPU tensors)."""
    return dict(xq=torch.zeros((m, k), dtype=torch.int8), x_scale=torch.tensor(0.02),
                wq_t=torch.zeros((n, k), dtype=torch.int8), w_scale=torch.ones(n),
                bias=torch.zeros(n), residual=torch.zeros((m, n), dtype=torch.bfloat16),
                out_dtype=torch.bfloat16)


def _misaligned_int8(rows: int, cols: int) -> torch.Tensor:
    """A contiguous int8 [rows, cols] view one byte past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 16, dtype=torch.int8)
    off = (-flat.data_ptr()) % 16 + 1
    return flat[off:off + rows * cols].view(rows, cols)


@pytest.mark.parametrize("change,want", [
    ({}, 0),
    ({"x_scale": torch.tensor([0.02])}, 0),
    ({"x_scale": torch.tensor([[0.02]])}, 0),
    ({"x_scale": torch.full((33, 1), 0.02)}, 1),
    ({"bias": None, "residual": None}, 0),
    ({"residual": torch.zeros((33, 48))}, 0),
    ({"out_dtype": torch.float32}, 0),
    # an [M] x_scale: a broadcast would read it along the columns
    ({"x_scale": torch.full((33,), 0.02)}, None),
    ({"x_scale": torch.full((33, 2), 0.02)[:, :1]}, None),   # [M, 1], not contiguous
    ({"x_scale": torch.tensor(0.02, dtype=torch.float64)}, None),
    ({"x_scale": 0.02}, None),                                # not a tensor
    ({"x_scale": torch.tensor([[[0.02]]])}, None),            # would make the output 3-D
    ({"xq": torch.zeros((33, 40), dtype=torch.int8),
      "wq_t": torch.zeros((48, 40), dtype=torch.int8)}, None),  # K % 16
    ({"xq": torch.zeros((33, 128), dtype=torch.int8)[:, :64]}, None),  # not contiguous
    ({"xq": _misaligned_int8(33, 64)}, None),
    ({"wq_t": _misaligned_int8(48, 64)}, None),
    ({"xq": torch.zeros((0, 64), dtype=torch.int8), "residual": None}, None),
    ({"xq": torch.zeros((33, 64), dtype=torch.uint8)}, None),
    ({"wq_t": torch.zeros((48, 32), dtype=torch.int8)}, None),  # another K
    ({"w_scale": torch.ones(48, dtype=torch.bfloat16)}, None),
    ({"w_scale": torch.ones((1, 48))}, 0),                    # broadcasts as [N]
    ({"w_scale": torch.ones(47)}, None),
    ({"bias": torch.zeros(48, dtype=torch.bfloat16)}, None),
    ({"bias": torch.zeros(47)}, None),
    ({"residual": torch.zeros((33, 48), dtype=torch.float16)}, None),
    ({"residual": torch.zeros((48, 33), dtype=torch.bfloat16).t()}, None),
    ({"out_dtype": torch.float16}, None),
    ({"w_scale": torch.ones(48, device="meta")}, None),       # another device
    ({"x_scale": torch.tensor(0.02, device="meta")}, None),
])
def test_q_matmul_pre_route_is_a_function_of_the_operands(change, want):
    """The card's checks, on CPU tensors: K9's GEMM takes the call (the
    stride of the row scales) or ``q_matmul_pre`` raises (None), from the
    operands' shapes, dtypes, layouts and devices alone."""
    ops = {**_pre_operands(), **change}
    if want is None:
        with pytest.raises(ValueError, match="q_matmul_pre"):
            _check_pre(**ops)
    else:
        assert _check_pre(**ops) == want


@pytest.mark.parametrize("name,route", [("ViT-L-14-336/openai", "lnk"),
                                        ("ViT-SO400M-14-SigLIP-384/webli", "wire")])
def test_cell_towers_send_every_block_product_to_the_gemm(monkeypatch, name, route):
    """One layer of each benchmarked int8_static tower at full width, on the
    CPU: every ``q_matmul_pre`` call of a forward (qkv, out, fc2) and every
    ``q_matmul_pre_act_q8`` call (fc1 with its int8 hidden) is one that K9's
    GEMM would take on the card, with one per-tensor scale, so the card's
    forward launches 3 × depth and depth and raises on none."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config(name), layers=1)
    params = quantize_vit_params(vit.init_vit_params(cfg, torch.Generator().manual_seed(0)))
    model = module_from_params(params, cfg)
    images = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    vit.attach_act_amax(model, vit.vit_act_amax(model, images), wire=vit.int8_wire_enabled(cfg))
    assert vit.block_route(model.blocks[0], cfg) == route
    strides = []

    def spy(xq, x_scale, wq_t, w_scale, bias=None, residual=None, out_dtype=torch.bfloat16):
        strides.append(_check_pre(match_k(xq, wq_t), x_scale, wq_t, w_scale, bias, residual,
                                  out_dtype))
        return q_matmul_pre(xq, x_scale, wq_t, w_scale, bias, residual, out_dtype)

    hidden = []

    def hidden_spy(xq, x_scale, wq_t, w_scale, bias, act, out_amax):
        hidden.append(_check_hidden_q8(match_k(xq, wq_t), x_scale, wq_t, w_scale, bias, act,
                                       out_amax))
        return q_matmul_pre_act_q8(xq, x_scale, wq_t, w_scale, bias, act, out_amax)

    monkeypatch.setattr(vit, "q_matmul_pre", spy)
    monkeypatch.setattr(vit, "q_matmul_pre_act_q8", hidden_spy)
    vit.vit_encode_image(model, images, torch.bfloat16)
    assert strides == [0] * 3 * cfg.layers
    assert hidden == [0] * cfg.layers


# ---- int8_static's fc1 with its int8 hidden: q_gemm_hidden_q8's epilogue ----------

FINITE_BF16 = (lambda v: v[torch.isfinite(v)])(
    torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16))
HIDDEN_ACTS = {"quick_gelu": quick_gelu, "gelu_tanh": gelu_tanh}


def _bf16r(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _act_steps(x: torch.Tensor, act: str) -> torch.Tensor:
    """The chain's activation as float32 steps on float32 x holding bf16
    values, each rounded to bf16 after it, the constants bf16, the
    transcendentals torch's float32 ``exp`` and ``tanh``, the division
    IEEE's: what each entry of the kernel's table holds before the
    quantize (and what an epilogue computing it in registers would run)."""
    def c(v):
        return torch.tensor(v, dtype=torch.bfloat16).item()

    one = torch.ones_like(x)
    if act == "quick_gelu":
        z = _bf16r(c(1.702) * x)
        sig = _bf16r(one / _bf16r(1.0 + _bf16r(torch.exp(-z))))
        return _bf16r(x * sig)
    x3 = _bf16r(_bf16r(x * x) * x)
    u = _bf16r(x + _bf16r(c(0.044715) * x3))
    t = _bf16r(torch.tanh(_bf16r(c(SQRT_2_OVER_PI) * u)))
    return _bf16r(x * _bf16r(0.5 * _bf16r(1.0 + t)))


def test_finite_bf16_sweep_holds_every_value():
    assert FINITE_BF16.numel() == 2 ** 16 - 2 ** 8
    assert torch.unique(FINITE_BF16.view(torch.int16)).numel() == FINITE_BF16.numel()


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
def test_hidden_activation_is_float32_steps_rounded_to_bf16_on_every_bf16(act):
    """The chain fc1's bf16 output ran through (``models/vit._act`` with
    quantized=True) is float32 steps each rounded to bf16, bit for bit, sign
    of zero included, on every finite bf16 value."""
    got = _act_steps(FINITE_BF16.float(), act).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), HIDDEN_ACTS[act](FINITE_BF16).view(torch.int16))


def _table_gather(y: np.ndarray, table: torch.Tensor) -> np.ndarray:
    """The kernel's ``hidden_q8`` on the epilogue's float32 y: the bits of
    bf16(y) index the table."""
    bits = torch.from_numpy(y).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return table.numpy()[bits.astype(np.int64)]


@pytest.mark.parametrize("amax", [3.0, 1e-3, 0.0])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
def test_hidden_table_holds_the_chain_for_every_bf16(act, amax):
    """``_hidden_table``: entry i is ``quant_static(act(v), amax)`` for the
    bf16 value v whose bits are i, as the chain computes it on a tensor of
    another shape and order (the values in reverse, [255, 256]), with an
    amax that clamps little, one that clamps most (1e-3) and 0 (the 1e-8
    floor)."""
    table = _hidden_table(act, torch.tensor([amax]))
    assert table.dtype == torch.int8 and table.shape == (2 ** 16,)
    vals = FINITE_BF16.flip(0).reshape(255, 256)
    chain = quant_static(HIDDEN_ACTS[act](vals), torch.tensor(amax))
    got = _table_gather(vals.float().numpy(), table)
    np.testing.assert_array_equal(got, chain.numpy())


@pytest.mark.parametrize("amax", [3.0, 1e-3, 0.0])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
def test_hidden_epilogue_on_every_bf16_matches_the_chain(act, amax):
    """With xq all zeros the bias sets every fc1 output: a bias row of every
    finite bf16 value, through the emulated epilogue and the table's
    gather, equals ``q_matmul_pre_act_q8`` (its plain chain: ``q_matmul_pre``'s
    bf16, the activation, ``quant_static``) bit for bit."""
    n, k = FINITE_BF16.numel(), 16
    xq = np.zeros((2, k), np.int8)
    wq = np.ones((n, k), np.int8)
    ws = np.full(n, 1e-3, np.float32)
    bias = FINITE_BF16.float().numpy()
    xs = np.float32(0.02)
    acc = xq.astype(np.int64) @ wq.astype(np.int64).T
    out_amax = torch.tensor([amax], dtype=torch.float32)
    got = _table_gather(_epilogue_f32(acc, np.array([xs]), ws, bias, xs_stride=0),
                        _hidden_table(act, out_amax))
    ref = q_matmul_pre_act_q8(torch.from_numpy(xq), torch.tensor(xs), torch.from_numpy(wq),
                              torch.from_numpy(ws), torch.from_numpy(bias), act, out_amax)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_tanh"])
@pytest.mark.parametrize("m,k,n", [(130, 128, 256), (37, 1152, 4304), (17, 64, 48)])
def test_hidden_epilogue_on_the_emulated_gemm_matches_the_chain(m, k, n, act):
    """Random int8 rows through the emulated schedule and epilogue, then the
    table's gather: the bits of the chain it replaces (``q_matmul_pre``, the
    bf16 activation, ``quant_static``), which fc2 then reads."""
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (n, k), dtype=np.int8)
    ws = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.normal(0, 0.5, n).astype(np.float32)
    xs = np.float32(0.02)
    t = {k_: torch.from_numpy(v) for k_, v in (("xq", xq), ("wq", wq), ("ws", ws), ("b", bias))}
    g = HIDDEN_ACTS[act](q_matmul_pre(t["xq"], torch.tensor(xs), t["wq"], t["ws"], t["b"]))
    amax = (0.9 * g.float().abs().max()).reshape(1)  # a few entries clamp
    chain = quant_static(g, amax)
    assert (chain.abs() == 127).any()
    acc, _ = _emulate_gemm(xq, wq)
    got = _table_gather(_epilogue_f32(acc, np.array([xs]), ws, bias, xs_stride=0),
                        _hidden_table(act, amax))
    np.testing.assert_array_equal(got, chain.numpy())
    ref = q_matmul_pre_act_q8(t["xq"], torch.tensor(xs), t["wq"], t["ws"], t["b"], act, amax)
    assert torch.equal(ref, chain)


def _hidden_operands(m=33, k=64, n=48):
    """A q_matmul_pre_act_q8 call's operands that the kernel takes (CPU tensors)."""
    return dict(xq=torch.zeros((m, k), dtype=torch.int8), x_scale=torch.tensor(0.02),
                wq_t=torch.zeros((n, k), dtype=torch.int8), w_scale=torch.ones(n),
                bias=torch.zeros(n), act="gelu_tanh", out_amax=torch.tensor([2.0]))


@pytest.mark.parametrize("change,want", [
    ({}, 0),
    ({"act": "quick_gelu"}, 0),
    ({"x_scale": torch.full((33, 1), 0.02)}, 1),
    ({"bias": None}, 0),
    ({"out_amax": torch.tensor(2.0)}, 0),                     # 0-d: one value
    ({"act": "gelu"}, None),                                   # the erf gelu: no instantiation
    ({"act": None}, None),
    ({"wq_t": torch.zeros((40, 64), dtype=torch.int8), "w_scale": torch.ones(40),
      "bias": torch.zeros(40)}, None),                         # N % 16: fc2 would pad
    ({"out_amax": torch.tensor([2.0, 3.0])}, None),
    ({"out_amax": torch.tensor([2.0], dtype=torch.float64)}, None),
    ({"out_amax": 2.0}, None),                                 # not a tensor
    ({"out_amax": torch.tensor([2.0], device="meta")}, None),  # another device
    ({"x_scale": torch.full((33,), 0.02)}, None),
    ({"xq": _misaligned_int8(33, 64)}, None),
    ({"xq": torch.zeros((33, 40), dtype=torch.int8),
      "wq_t": torch.zeros((48, 40), dtype=torch.int8)}, None),  # K % 16
    ({"w_scale": torch.ones(48, dtype=torch.bfloat16)}, None),
])
def test_hidden_q8_route_is_a_function_of_the_operands(change, want):
    """The card's checks, on CPU tensors: the kernel takes the call (the
    stride of the row scales) or ``q_matmul_pre_act_q8`` raises (None), from
    the operands alone; a CUDA tensor never falls back to the chain."""
    ops = {**_hidden_operands(), **change}
    if want is None:
        with pytest.raises(ValueError, match="q_matmul_pre_act_q8"):
            _check_hidden_q8(**ops)
    else:
        assert _check_hidden_q8(**ops) == want


def _static_tower(name: str, wire: bool = False, **replace):
    """A calibrated int8_static tower of ``name`` (its config with
    ``replace``), and two images, on the CPU."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models import vit
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

    cfg = dataclasses.replace(vit.resolve_config(name), **replace)
    params = quantize_vit_params(vit.init_vit_params(cfg, torch.Generator().manual_seed(0)))
    model = module_from_params(params, cfg)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    vit.attach_act_amax(model, vit.vit_act_amax(model, images), wire=wire)
    return cfg, model, images


@pytest.mark.parametrize("name,wire,replace,route,dtype,takes", [
    ("ViT-Test/tiny", False, {"width": 128}, "lnk", torch.bfloat16, True),        # quick_gelu
    ("PE-Test/tiny", False, {"width": 128}, "lnk", torch.bfloat16, True),         # gelu, RoPE
    ("SigLIP-Test/tiny", True, {}, "wire", torch.bfloat16, True),                 # gelu_tanh
    ("ViT-Test/tiny", False, {}, "static", torch.bfloat16, True),
    ("SigLIP-Test/tiny", False, {}, "static", torch.bfloat16, True),
    ("EVA-Test-Wide/tiny", False, {}, "lnk", torch.bfloat16, False),              # swiglu
    ("EVA-Test/tiny", False, {}, "static", torch.bfloat16, False),                # swiglu
    ("EVA-Test-Post/tiny", False, {}, "static", torch.bfloat16, False),           # post-norm
    ("ViT-Test/tiny", False, {"width": 128, "mlp_hidden": 200}, "lnk", torch.bfloat16, False),
    ("ViT-Test/tiny", False, {"mlp_hidden": 72}, "static", torch.bfloat16, False),
    ("SigLIP-Test/tiny", True, {}, "wire", torch.float32, False),                 # f32 hidden
    ("ViT-Test/tiny", False, {}, "static", torch.float32, False),
])
def test_int8_static_mlp_takes_the_int8_hidden(monkeypatch, name, wire, replace, route, dtype,
                                               takes):
    """Which int8_static blocks keep the MLP hidden in int8, on the CPU: the
    lnk, wire and static blocks whose MLP is fc1 → quick_gelu or gelu → fc2
    with a bf16 hidden 16 divides call ``q_matmul_pre_act_q8`` once a layer
    and ``q_matmul_pre`` three times; swiglu, post-norm, ragged and float32
    hiddens keep the chain. Either way the embeddings equal the chain's
    (``_hidden_q8_act`` forced to None) bit for bit."""
    from clip_assisted_data_labeling_tpu_torch.models import vit

    cfg, model, images = _static_tower(name, wire, **replace)
    rope = vit._rope_on(cfg, torch.device("cpu")) if cfg.use_rope2d else None
    assert vit.block_route(model.blocks[0], cfg, rope) == route
    calls = {"pre": 0, "hidden": 0}

    def count(key, fn):
        def spy(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return spy

    monkeypatch.setattr(vit, "q_matmul_pre", count("pre", q_matmul_pre))
    monkeypatch.setattr(vit, "q_matmul_pre_act_q8", count("hidden", q_matmul_pre_act_q8))
    emb = vit.vit_encode_image(model, images, dtype)
    assert calls["hidden"] == (cfg.layers if takes else 0)
    if takes:
        assert calls["pre"] == 3 * cfg.layers
    monkeypatch.setattr(vit, "_hidden_q8_act", lambda *a: None)
    assert torch.equal(emb, vit.vit_encode_image(model, images, dtype))


# ---- K6: the row pass's layernorm sums -------------------------------------------

def _schedule(k: int, vec: int) -> tuple[int, int] | None:
    """(warps a row, vectors a lane) for a row of k values, vec a vector;
    None for a row past every schedule (the staged kernels take it)."""
    nv = k // vec
    return next(((w, l) for w, l in VEC_SCHEDULES if nv <= 32 * w * l), None)


def _fma32(a, b, c):
    """float32 fmaf through float64 (a·b is exact there; the sum rounds
    twice, off by an ulp on rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _group_sum(part: np.ndarray, wpr: int) -> np.ndarray:
    """part [rows, 32·wpr] lane partials → [rows] as the kernel adds them:
    the xor butterfly in each warp, then the warps' totals in warp order."""
    v = part.reshape(part.shape[0], wpr, 32).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, :, lanes ^ o]
    t = v[:, 0, 0]
    for w in range(1, wpr):
        t = t + v[:, w, 0]
    return t


def _emulate_rowquant_ln(x: np.ndarray, gamma, beta, vec: int, eps: float = 1e-5,
                         amax=None):
    """K6's layernorm + quantize in the kernel's order: x [rows, K] float32
    (the bf16 input already widened). With ``amax`` (K2, the static mode):
    that scale for every row, no floor, and no row scales (None)."""
    rows, k = x.shape
    wpr, loads = _schedule(k, vec)
    g = 32 * wpr
    nv = k // vec
    xv = x.reshape(rows, nv, vec)
    s = np.zeros((rows, g), np.float32)
    for i in range(loads):  # lane l's vectors l + i·G, each value in order
        c = np.arange(g) + i * g
        ok = c < nv
        for e in range(vec):
            s[:, ok] = s[:, ok] + xv[:, c[ok], e]
    mu = _group_sum(s, wpr) / np.float32(k)
    s2 = np.zeros((rows, g), np.float32)
    for i in range(loads):
        c = np.arange(g) + i * g
        ok = c < nv
        for e in range(vec):
            dv = xv[:, c[ok], e] - mu[:, None]
            s2[:, ok] = _fma32(dv, dv, s2[:, ok])
    var = _group_sum(s2, wpr) / np.float32(k)
    rs = np.float32(1.0) / np.sqrt(var + np.float32(eps))
    y = (x - mu[:, None]) * rs[:, None]
    y = y * gamma + beta
    if amax is not None:
        q = np.clip(np.rint(y * (np.float32(127.0) / np.float32(amax))), -127, 127)
        return q.astype(np.int8), None
    amax = np.maximum(np.abs(y).max(axis=1), np.float32(1e-8))
    q = np.clip(np.rint(y * (np.float32(127.0) / amax)[:, None]), -127, 127).astype(np.int8)
    return q, (amax * np.float32(1.0 / 127.0)).reshape(-1, 1)


@pytest.mark.parametrize("dtype,k,rows,kernel", [
    # K6: ViT-L's ln1 / ln2 (hybrid: [18464, 1024] in bf16)
    pytest.param(torch.bfloat16, 1024, 2048, "K6", id="dtype0-1024-2048"),
    pytest.param(torch.float32, 1024, 2048, "K6", id="dtype1-1024-2048"),
    # SO400M-384's ([23328, 1152])
    pytest.param(torch.bfloat16, 1152, 1024, "K6", id="dtype2-1152-1024"),
    pytest.param(torch.bfloat16, 4096, 256, "K6", id="dtype3-4096-256"),  # K8's ln at 4096
    # K2 (static scale): int8_static's lnk rows of ViT-L-14-336 and PE-L14
    # ([18464, 1024] bf16, one warp a row), SO400M-384 under CTPU_INT8_WIRE=0
    # ([23328, 1152], two warps), and 1024 in float32 (two warps)
    pytest.param(torch.bfloat16, 1024, 2048, "K2", id="K2-bf16-1024-2048"),
    pytest.param(torch.bfloat16, 1152, 1024, "K2", id="K2-bf16-1152-1024"),
    pytest.param(torch.float32, 1024, 2048, "K2", id="K2-f32-1024-2048"),
])
def test_rowquant_ln_sum_order_within_the_card_limits(dtype, k, rows, kernel):
    rng = np.random.default_rng(k)
    x = torch.from_numpy((rng.normal(0, 1, (rows, k)) * 2).astype(np.float32)).to(dtype)
    gamma = (1 + 0.1 * rng.normal(0, 1, k)).astype(np.float32)
    beta = (0.1 * rng.normal(0, 1, k)).astype(np.float32)
    vec = 16 // x.element_size()
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    if kernel == "K2":  # the card tests' static scale
        q, _ = _emulate_rowquant_ln(x.float().numpy(), gamma, beta, vec, amax=6.0)
        rq = rowquant_static_plain(x, g, b, torch.tensor([6.0]))
    else:
        q, s = _emulate_rowquant_ln(x.float().numpy(), gamma, beta, vec)
        rq, rs = rowquant_plain(x, g, b)
        np.testing.assert_allclose(s, rs.numpy(), rtol=1e-6, atol=0)
    diff = np.abs(q.astype(np.int32) - rq.numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE


@pytest.mark.parametrize("k,vec,want", [
    (1024, 8, (1, 4)), (1152, 8, (2, 4)), (4096, 8, (8, 2)), (4304, 8, (8, 4)),
    (1024, 4, (2, 4)), (4096, 4, (8, 4)), (72, 8, (1, 4)),
    # past every schedule: bf16 past 8192 and f32 past 4096 are staged
    (8200, 8, None), (4100, 4, None),
])
def test_rowquant_schedules_at_the_paths_widths(k, vec, want):
    """The schedule each width takes (8 bf16 or 4 float32 values a vector):
    ViT-L's 1024 with one warp a row, no block barrier. K6 and K2 take the
    same table: both launch through ``launch_rows_vec``, K2 in its static
    mode, and stage only what it refuses."""
    assert _schedule(k, vec) == want
    for src, mode in (("rowquant.cu", "false"), ("rowquant_static.cu", "true")):
        text = (CSRC / src).read_text()
        assert re.search(rf"launch_rows_vec<T, \w+, {mode}>\(", text), src
        assert "kNoSchedule" in text and "#define RQ_VEC_SCHEDULES" not in text, src
