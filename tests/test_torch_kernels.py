"""The port's kernel plain versions against the JAX package's Pallas kernels
(run in interpret mode on the CPU): K1 packed attention, K2 layernorm +
static int8 quantize, K3 the int8 attention wire, K5 flash attention; and
the port's calibration attention against the JAX package's XLA path. On a
CPU tensor each port wrapper takes its plain version, so these tests also
pin the dispatch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops.attention import attention_xla as jax_attention_xla
from clip_assisted_data_labeling_tpu.ops.attention import (
    flash_attention_packed as jax_flash_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed as jax_fused_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed_q8s as jax_fused_attention_packed_q8s,
)
from clip_assisted_data_labeling_tpu.ops.quant import quant_static as jax_quant_static
from clip_assisted_data_labeling_tpu.ops.quant_kernel import (
    rowquant_static as jax_rowquant_static,
)
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    attention_xla,
    flash_attention_packed,
    fused_attention_packed,
    fused_attention_packed_plain,
    fused_attention_packed_q8s,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import quant_static
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    rowquant_static,
    rowquant_static_plain,
)

W, HEADS = 128, 2  # head dim 64: the scale 0.125 is exact in bf16
# f32: the same arithmetic, summed in another order; bf16: ~2 bf16 ulps on
# unit-scale outputs (the output rounds to bf16 after float32 sums)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_attention(qkv32: np.ndarray, dtype, s_real):
    out = jax_fused_attention_packed(
        jnp.asarray(qkv32).astype(JNP[dtype]), heads=HEADS, scale=64 ** -0.5,
        s_real=s_real, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real", [(2, 17, 17), (2, 50, 43), (1, 577, 577)])
def test_packed_attention_plain_matches_pallas(rng, dtype, b, s, s_real):
    qkv = rng.normal(0, 1, (b, s, 3 * W)).astype(np.float32)
    qkv_t = torch.from_numpy(qkv).to(dtype)
    got = fused_attention_packed(qkv_t, heads=HEADS, scale=64 ** -0.5, s_real=s_real)
    assert got.dtype == dtype and got.shape == (b, s, W)
    ref = _jax_attention(qkv_t.float().numpy(), dtype, s_real)
    # rows past s_real are never read downstream; compare the real ones
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"


def test_packed_attention_wrapper_uses_plain_on_cpu(rng):
    qkv = torch.from_numpy(rng.normal(0, 1, (1, 9, 3 * W)).astype(np.float32))
    before = fused_attention_packed.launches
    a = fused_attention_packed(qkv, heads=HEADS, scale=0.125)
    b = fused_attention_packed_plain(qkv, heads=HEADS, scale=0.125)
    assert torch.equal(a, b)
    assert fused_attention_packed.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [18, 577])
def test_rowquant_static_plain_matches_pallas(rng, dtype, m):
    k = 128
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    lns = rng.normal(1, 0.1, (k,)).astype(np.float32)
    lnb = rng.normal(0, 0.1, (k,)).astype(np.float32)
    amax = np.float32(6.0)
    x_t = torch.from_numpy(x).to(dtype)
    got = rowquant_static(x_t, torch.from_numpy(lns), torch.from_numpy(lnb),
                          torch.tensor([amax]))
    assert got.dtype == torch.int8 and got.shape == (m, k)
    ref = np.asarray(jax_rowquant_static(
        jnp.asarray(x_t.float().numpy()).astype(JNP[dtype]), jnp.asarray(lns),
        jnp.asarray(lnb), amax, block_m=8, interpret=True))
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    # sums taken in another order can flip a round-half boundary: ±1, rarely
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_rowquant_static_no_amax_floor_and_clip():
    """Like the TPU kernel: no 1e-8 floor on amax, values beyond ±amax clip."""
    x = torch.tensor([[0.0, 1.0, 2.0, 3.0] * 32])
    q = rowquant_static_plain(x, torch.ones(128), torch.zeros(128), torch.tensor([0.5]))
    assert q.max().item() == 127 and q.min().item() == -127


@pytest.mark.parametrize("b,s,heads,d", [(2, 9, 3, 8), (1, 729, 2, 72)])
def test_q8s_attention_plain_matches_pallas(rng, b, s, heads, d):
    """K3. At S=729 the JAX kernel pads to 736 and runs two 368-row tiles."""
    w = heads * d
    qkv = rng.integers(-127, 128, (b, s, 3 * w)).astype(np.int8)
    # scores of std ~3 at d=72, outputs over much of the int8 range
    cs = np.concatenate([rng.uniform(0.5, 1.5, 2 * w) * 8e-3,
                         rng.uniform(0.5, 1.5, w) * 0.5]).astype(np.float32)
    got = fused_attention_packed_q8s(torch.from_numpy(qkv), torch.from_numpy(cs), heads)
    assert got.dtype == torch.int8 and got.shape == (b, s, w)
    ref = np.asarray(jax_fused_attention_packed_q8s(
        jnp.asarray(qkv), jnp.asarray(cs), heads=heads, scale=d ** -0.5, interpret=True))
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    # float32 sums in another order can move a value across a half: ±1, rarely
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert np.abs(ref).mean() > 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,heads,d", [(1, 729, 729, 2, 72), (2, 50, 43, 2, 64)])
def test_flash_attention_plain_matches_pallas(rng, dtype, b, s, s_real, heads, d):
    """K5, with the JAX flash kernel's panels (368 keys at S=729)."""
    w = heads * d
    qkv_t = torch.from_numpy(rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)).to(dtype)
    got = flash_attention_packed(qkv_t, heads, d ** -0.5, s_real)
    assert got.dtype == dtype and got.shape == (b, s, w)
    ref = np.asarray(jax_flash_attention_packed(
        jnp.asarray(qkv_t.float().numpy()).astype(JNP[dtype]), heads=heads, scale=d ** -0.5,
        s_real=s_real, interpret=True).astype(jnp.float32))
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    # bf16: at most one bf16 ulp of these outputs (seen: 9.8e-4 at S=729;
    # f32 4.2e-7)
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_xla_matches_jax(rng, dtype):
    q, k, v = (rng.normal(0, 1, (2, 3, 20, 16)).astype(np.float32) for _ in range(3))
    got = attention_xla(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)), scale=0.3)
    assert got.dtype == dtype
    ref = np.asarray(jax_attention_xla(*(jnp.asarray(t).astype(JNP[dtype]) for t in (q, k, v)),
                                       0.3).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype] / 2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_static_per_channel_bit_exact(rng, dtype):
    """The int8 wire's per-channel quantize (and the per-tensor one) equal
    the JAX package's, bit for bit; a dead channel quantizes to zeros."""
    x = rng.normal(0, 2, (7, 48)).astype(np.float32)
    amax = rng.uniform(0.5, 4, 48).astype(np.float32)
    x[:, 3], amax[3] = 0.0, 0.0  # a dead channel: no NaN from 0 * (127 / 0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(JNP[dtype])
    for a in (amax, amax[5]):
        got = quant_static(xt, torch.from_numpy(np.asarray(a)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_quant_static(xj, a)))
    assert not quant_static(xt, torch.from_numpy(amax))[:, 3].any()
