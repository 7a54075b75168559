"""The port's dry run (``clip_assisted_data_labeling_tpu_torch/dryrun.py``) on
the CPU: the whole sequence on meshes that list the CPU 2 and 4 times (the
1-D and the 2-D branch), its data-parallel SGD step against the one-device
step and against the JAX package's ``value_and_grad`` step from the same
initial weights, and the flagship step's example args against
``__graft_entry__._example_batch`` bit for bit. The full-width flagship
forward runs on the card only (``chip_smoke.py`` phase 44)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch as jax_example_batch
from clip_assisted_data_labeling_tpu.models.regressor import regressor_apply
from clip_assisted_data_labeling_tpu_torch import dryrun
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh

CPU = torch.device("cpu")
DRYRUN_LINES = {
    2: ["dp embed over", "dp {'data': 2} matches single-device output",
        "post-norm dp int8_static over", "ring dedup over", "dp train step over",
        "dp predict over", "OK on 2 devices"],
    4: ["dp+tp embed over", "dp+tp {'data': 2, 'model': 2} matches single-device output",
        "tp int8_static over", "EVA02 tp int8_static over", "post-norm dp int8_static over",
        "ring dedup over", "dp train step over", "dp predict over", "OK on 4 devices"],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the suite's
    other workers, so these tests run on one (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_passes_every_check(n_devices, capsys):
    figures = dryrun.dryrun_multichip(n_devices, "cpu")
    lines = [ln[len("[dryrun] "):] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[dryrun] ")]
    assert len(lines) == len(DRYRUN_LINES[n_devices])
    for line, head in zip(lines, DRYRUN_LINES[n_devices]):
        assert line.startswith(head), (line, head)
    assert figures["devices"] == ["cpu"] * n_devices
    assert figures["ring_pairs"] == [(0, 8 * n_devices - 1)]
    assert figures["embed"]["min_cos"] > 0.999 and figures["post_norm"]["min_cos"] > 0.9999
    assert figures["sgd"]["max_abs_diff"] <= 1e-6 and figures["predict_max_abs_diff"] <= 1e-6
    assert figures.get("tp_static_equal", True) and figures.get("eva_tp_static_equal", True)
    assert ("tp_static_equal" in figures) == (n_devices == 4)


def test_dp_sgd_step_matches_one_device_and_jax(rng):
    params = dryrun.regressor_params(32)
    x = rng.normal(0, 1, (8, 32)).astype(np.float32)
    y = rng.uniform(0, 1, 8).astype(np.float32)
    dp, dp_loss = dryrun.dp_sgd_step(params, x, y, get_mesh(devices=[CPU] * 4))
    one, one_loss = dryrun.dp_sgd_step(params, x, y, get_mesh(devices=[CPU]))

    def loss_fn(p):
        return jnp.mean((regressor_apply(p, jnp.asarray(x))[:, 0] - jnp.asarray(y)) ** 2)

    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jloss, grads = jax.value_and_grad(loss_fn)(jparams)
    jstep = jax.tree.map(lambda a, g: np.asarray(a - dryrun.SGD_LR * g), jparams, grads)
    for a, b, c in zip(dp, one, jstep):
        for k in ("kernel", "bias"):
            assert a[k].dtype == np.float32 and a[k].shape == c[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            np.testing.assert_allclose(a[k], c[k], rtol=0, atol=1e-6)
    assert abs(dp_loss - one_loss) <= 1e-6 and abs(dp_loss - float(jloss)) <= 1e-6
    assert any(not np.array_equal(a["kernel"], p["kernel"]) for a, p in zip(dp, params))


def test_example_args_are_the_jax_files_bit_for_bit():
    canvases, crop_params = dryrun.example_args()
    want_c, want_p = jax_example_batch(2, 512, 224)
    assert canvases.dtype == want_c.dtype and np.array_equal(canvases, want_c)
    assert crop_params.dtype == want_p.dtype and np.array_equal(crop_params, want_p)
    got_c, got_p = dryrun._example_batch(8, 128, 32, seed=3)
    want_c, want_p = jax_example_batch(8, 128, 32, seed=3)
    assert np.array_equal(got_c, want_c) and np.array_equal(got_p, want_p)


def test_dryrun_needs_a_card_or_the_cpu():
    assert dryrun.mesh_devices(3, "cpu") == [CPU] * 3
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: dryrun.mesh_devices(2), lambda: dryrun.dryrun_multichip(2),
                 lambda: dryrun.entry()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
