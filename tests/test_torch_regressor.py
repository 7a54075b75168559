"""The port's SimpleFC regressor (models/regressor.py) against the JAX
package's, on the CPU, at widths that differ layer to layer (40 → 24 → 12 →
1 or 3), so that a missing [in, out] ↔ [out, in] transpose fails.

What must agree, within 1e-6: the forward in both heads, every predict wire
(float32, float16, int8, and a NaN row or a batch over 6e4 that takes the
exact wire), the classification's expected value and argmax, and a
checkpoint written by either package (.npz, and the .pth pickle in one
process and through a subprocess) read by the other. ``describe`` gives the
same text. Dropout, drawn from torch generators where JAX draws threefry
bits, is held to its statistics. The header reader of the subset stage
(data/imsize.py) is held against PIL here too."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.models import regressor as jreg
from clip_assisted_data_labeling_tpu_torch.data import imsize
from clip_assisted_data_labeling_tpu_torch.models import regressor as treg

F_IN, HIDDEN = 40, (24, 12)
CLASSES = (0.0, 2.0, 5.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(head: str, dropout: float = 0.0) -> jreg.RegressorMeta:
    return jreg.RegressorMeta(
        clip_models=("ViT-Test/tiny",), crop_names=("centre_crop", "subcrop2_0.1"),
        input_size=F_IN, hidden_sizes=HIDDEN,
        output_size=len(CLASSES) if head == "classification" else 1,
        dropout_prob=dropout, data_min=1.0, data_max=9.0,
        class_values=CLASSES if head == "classification" else None)


def _pair(head: str, seed: int = 3, dropout: float = 0.0):
    """(JAX regressor from a JAX key, the port's regressor carrying its weights)."""
    meta = _meta(head, dropout)
    jm = jreg.SimpleFCRegressor.create(jax.random.key(seed), meta)
    tm = treg.regressor_from_params(
        [{k: np.asarray(v) for k, v in p.items()} for p in jm.params],
        treg.RegressorMeta(**dataclasses.asdict(meta)), "cpu")
    return jm, tm


def _features(seed: int, n: int = 37) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (n, F_IN)).astype(np.float32)


@pytest.mark.parametrize("head", ["sigmoid", "linear"])
def test_forward_matches_jax(head):
    jm, tm = _pair("classification" if head == "linear" else "regression")
    x = _features(0)
    want = np.asarray(jreg.regressor_apply(jm.params, jnp.asarray(x), head=head))
    with torch.no_grad():
        got = tm.net(torch.from_numpy(x), head=head).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_weights_carry_over_transposed():
    jm, tm = _pair("regression")
    for lin, p in zip(tm.net.linears, jm.params):
        assert tuple(lin.weight.shape) == np.asarray(p["kernel"]).shape[::-1]
    for got, p in zip(tm.params(), jm.params):
        np.testing.assert_array_equal(got["kernel"], np.asarray(p["kernel"]))
        np.testing.assert_array_equal(got["bias"], np.asarray(p["bias"]))


@pytest.mark.parametrize("head", ["regression", "classification"])
def test_describe_matches_jax(head):
    jm, tm = _pair(head, dropout=0.25)
    assert tm.describe() == jm.describe()


@pytest.mark.parametrize("head", ["regression", "classification"])
@pytest.mark.parametrize("wire", ["float32", "float16", "int8"])
def test_predict_wires_match_jax(head, wire):
    """Each wire against the JAX method's same wire, in two batches: the
    first holds a NaN row (float16 and int8 send that batch as float32),
    the second a value over 6e4 (float16 sends it as float32)."""
    jm, tm = _pair(head)
    x = _features(1, 48)
    x[5, 3] = np.nan
    x[30, 7] = 7.0e4
    want = jm.predict(x, batch_size=24, wire=wire)
    got = tm.predict(x, batch_size=24, wire=wire)
    assert got.shape == (48,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, equal_nan=True)
    assert np.isnan(got[5]) and np.isfinite(np.delete(got, 5)).all()


@pytest.mark.parametrize("wire", ["float16", "int8"])
def test_lossy_wires_send_what_jax_sends(wire):
    """On finite rows in fp16 range the lossy wires really are lossy: the
    scores differ from the float32 wire's, and equal the JAX same wire's."""
    jm, tm = _pair("regression")
    x = _features(2) * 3
    got = tm.predict(x, wire=wire)
    assert np.abs(got - tm.predict(x, wire="float32")).max() > 0
    np.testing.assert_allclose(got, jm.predict(x, wire=wire), atol=1e-6)


def test_predict_classes_matches_jax():
    jm, tm = _pair("classification")
    x = _features(3)
    got = tm.predict_classes(x, batch_size=16)
    np.testing.assert_array_equal(got, jm.predict_classes(x, batch_size=16))
    assert set(got.tolist()) <= set(CLASSES)
    with pytest.raises(ValueError, match="classification"):
        _pair("regression")[1].predict_classes(x)


def test_unknown_wire_raises():
    """The JAX method takes an unknown wire as float32; the port refuses it."""
    jm, tm = _pair("regression")
    x = _features(4, 3)
    np.testing.assert_allclose(jm.predict(x, wire="bf16"), jm.predict(x), atol=0)
    with pytest.raises(ValueError, match="unknown wire 'bf16'"):
        tm.predict(x, wire="bf16")
    assert tm.predict(x[:0]).shape == (0,)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("head", ["regression", "classification"])
def test_npz_both_ways(tmp_path, writer, head):
    jm, tm = _pair(head, seed=5, dropout=0.5)
    path = str(tmp_path / "m.npz")
    x = _features(5)
    if writer == "jax":
        jm.save(path)
        back = treg.SimpleFCRegressor.load(path, device="cpu")
        np.testing.assert_allclose(back.predict(x), jm.predict(x), atol=1e-6)
        assert dataclasses.asdict(back.meta) == dataclasses.asdict(jm.meta)
    else:
        tm.save(path)
        back = jreg.SimpleFCRegressor.load(path)
        np.testing.assert_allclose(back.predict(x), tm.predict(x), atol=1e-6)
        assert dataclasses.asdict(back.meta) == dataclasses.asdict(tm.meta)
        with np.load(path) as f:
            assert f["layer0/kernel"].shape == (F_IN, HIDDEN[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_pickle_both_ways_in_one_process(tmp_path, writer):
    """Both packages install the same ``utils.nn_model`` shim; whichever came
    first serves both, and each reads the other's pickle."""
    jm, tm = _pair("regression", seed=6, dropout=0.25)
    path = str(tmp_path / "m.pth")
    x = _features(6)
    (jm if writer == "jax" else tm).save_torch_pickle(path)
    for back in (treg.SimpleFCRegressor.load_torch_pickle(path, device="cpu"),
                 jreg.SimpleFCRegressor.load_torch_pickle(path)):
        np.testing.assert_allclose(back.predict(x), jm.predict(x), atol=1e-6)
        assert back.meta.hidden_sizes == HIDDEN
        assert back.meta.clip_models == ("ViT-Test/tiny",)
        assert (back.meta.data_min, back.meta.data_max) == (1.0, 9.0)
    import utils.nn_model as shim

    from clip_assisted_data_labeling_tpu_torch.utils import plots

    assert shim.SimpleFC.__module__ == "utils.nn_model"
    assert shim.SimpleFC.__qualname__ == "SimpleFC"
    # the shim's top-level ``utils`` never stands for the port's own package
    assert sys.modules["utils"] is not sys.modules["clip_assisted_data_labeling_tpu_torch.utils"]
    assert plots.__name__ == "clip_assisted_data_labeling_tpu_torch.utils.plots"
    mod = torch.load(path, map_location="cpu", weights_only=False)
    assert [type(m).__name__ for m in mod.layers] == [
        "Linear", "LeakyReLU", "Dropout", "Linear", "LeakyReLU", "Dropout", "Linear",
        "Sigmoid"]


_READ_PORT = """
import sys, numpy as np
from clip_assisted_data_labeling_tpu_torch.models.regressor import SimpleFCRegressor
m = SimpleFCRegressor.load_torch_pickle(sys.argv[1], device="cpu")
np.save(sys.argv[3], m.predict(np.load(sys.argv[2])))
assert "jax" not in sys.modules and "clip_assisted_data_labeling_tpu" not in sys.modules
"""
_READ_JAX = """
import sys, numpy as np
from clip_assisted_data_labeling_tpu.models.regressor import SimpleFCRegressor
m = SimpleFCRegressor.load_torch_pickle(sys.argv[1])
np.save(sys.argv[3], m.predict(np.load(sys.argv[2])))
assert "clip_assisted_data_labeling_tpu_torch" not in sys.modules
"""


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_pickle_through_a_subprocess(tmp_path, writer):
    """A pickle written here loads in a fresh process holding only the
    other package, which installs its own shim."""
    jm, tm = _pair("regression", seed=7)
    path, xs, out = (str(tmp_path / n) for n in ("m.pth", "x.npy", "out.npy"))
    x = _features(7)
    np.save(xs, x)
    (jm if writer == "jax" else tm).save_torch_pickle(path)
    script = _READ_PORT if writer == "jax" else _READ_JAX
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, path, xs, out], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_allclose(np.load(out), jm.predict(x), atol=1e-6)


def test_torch_export_is_regression_only(tmp_path):
    _jm, tm = _pair("classification")
    with pytest.raises(ValueError, match="regression-only"):
        tm.save_torch_pickle(str(tmp_path / "m.pth"))


def test_create_init_distribution_and_seed():
    """U(±1/√fan_in) for every weight and bias, from a CPU generator: the
    same seed gives the same weights, another seed others."""
    meta = treg.RegressorMeta(**dataclasses.asdict(_meta("regression")))
    a = treg.SimpleFCRegressor.create(meta, 42, "cpu")
    b = treg.SimpleFCRegressor.create(meta, 42, "cpu")
    c = treg.SimpleFCRegressor.create(meta, 43, "cpu")
    for la, lb, lc in zip(a.net.linears, b.net.linears, c.net.linears):
        bound = 1 / np.sqrt(la.in_features)
        for pa, pb, pc in ((la.weight, lb.weight, lc.weight), (la.bias, lb.bias, lc.bias)):
            assert torch.equal(pa, pb) and not torch.equal(pa, pc)
            assert pa.abs().max() <= bound and pa.abs().max() > 0.8 * bound


def test_dropout_statistics():
    """The mask keeps a share 1 − p of the activations, scales them by
    1/(1 − p) and zeroes the rest; one generator seed gives one mask, and
    no generator means no dropout. The net's first layer makes every hidden
    activation 1 and its last is the identity, so the linear head returns
    the dropped hidden layer."""
    p, n = 0.3, 1024
    net = treg.SimpleFC(8, (n,), n, dropout_prob=p)
    with torch.no_grad():
        net.linears[0].weight.zero_()
        net.linears[0].bias.fill_(1.0)
        net.linears[1].weight.copy_(torch.eye(n))
        net.linears[1].bias.zero_()
    x = torch.zeros((16, 8))

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return net(x, gen, head="linear")

    a, b, c, none = run(1), run(1), run(2), run(None)
    kept = a != 0
    share = kept.float().mean().item()
    # 16384 Bernoulli draws: the share within 5 standard deviations of 1 − p
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / a.numel())
    np.testing.assert_allclose(a[kept].numpy(), 1 / (1 - p), rtol=1e-6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(none, torch.ones_like(none))


@pytest.mark.parametrize("kind", ["jpeg", "progressive_jpeg", "png", "gray_jpeg"])
def test_header_reader_gives_pils_size(tmp_path, kind):
    """data/imsize.py reads (width, height) from the header alone, as PIL
    gives it, with PIL installed or not; gray_jpeg_bytes' files decode
    to a uniform gray image of the size asked for."""
    rng = np.random.default_rng(len(kind))
    sizes = [(77, 123), (640, 480), (1, 1), (1000, 33)]
    for w, h in sizes:
        path = str(tmp_path / f"{kind}_{w}x{h}.jpg")
        if kind == "gray_jpeg":
            with open(path, "wb") as f:
                f.write(imsize.gray_jpeg_bytes(w, h))
            with Image.open(path) as im:
                assert np.all(np.asarray(im.convert("L")) == 128)
        else:
            arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            fmt = "PNG" if kind == "png" else "JPEG"
            Image.fromarray(arr).save(path, format=fmt, progressive=kind.startswith("prog"))
        with Image.open(path) as im:
            want = im.size
        assert imsize.image_size(path) == want == (w, h)
        own = imsize.png_size(path) if kind == "png" else imsize.jpeg_size(path)
        assert own == want
    (tmp_path / "not_an_image.jpg").write_bytes(b"hello")
    assert imsize.jpeg_size(str(tmp_path / "not_an_image.jpg")) is None
    with pytest.raises(Exception):
        imsize.image_size(str(tmp_path / "not_an_image.jpg"))


def test_header_reader_without_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(imsize, "Image", None)
    (tmp_path / "a.jpg").write_bytes(imsize.gray_jpeg_bytes(300, 200))
    Image.fromarray(np.zeros((5, 9, 3), np.uint8)).save(tmp_path / "b.png")
    assert imsize.image_size(str(tmp_path / "a.jpg")) == (300, 200)
    assert imsize.image_size(str(tmp_path / "b.png")) == (9, 5)
    (tmp_path / "c.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    with pytest.raises(ValueError, match="before any SOF"):
        imsize.image_size(str(tmp_path / "c.jpg"))
    (tmp_path / "d.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        imsize.image_size(str(tmp_path / "d.jpg"))
