"""Stage 4 of the port (pipeline/train.py) against the JAX package's, on the
CPU, at small widths (F = 40, hidden 24 and 12).

JAX draws its initial weights, its epoch permutations and its dropout
masks from threefry keys, which torch cannot reproduce. So the training
runs here start from the JAX package's initial weights, carried over with
``regressor_from_params``, run without dropout, and take either one batch
an epoch (where the order inside the batch only reorders a sum) or JAX's
own permutation. Parameters and loss curves must then agree within 1e-6,
in regression and under classification. The data loading must give the
JAX function's rows in its order under the same ``np.random.seed``, from a
columnar store and from sidecars; the schedule and the padding are
compared directly."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.config import TrainConfig as JaxTrainConfig
from clip_assisted_data_labeling_tpu.models import regressor as jreg
from clip_assisted_data_labeling_tpu.pipeline import train as jtrain
from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
from clip_assisted_data_labeling_tpu_torch.config import TrainConfig as PortTrainConfig
from clip_assisted_data_labeling_tpu_torch.models import regressor as treg
from clip_assisted_data_labeling_tpu_torch.pipeline import train as ttrain
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar
from clip_assisted_data_labeling_tpu_torch.utils import plots

F_IN, HIDDEN = 40, (24, 12)
MODEL = "ViT-Test/tiny"


def _cfgs(**kw):
    base = dict(crop_names=("centre_crop",), hidden_sizes=HIDDEN, dropout_prob=0.0,
                test_fraction=0.25)
    base.update(kw)
    return JaxTrainConfig(**base), PortTrainConfig(**base)


def _data(seed: int, n: int, classification: bool):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, F_IN)).astype(np.float32)
    y = (rng.integers(0, 4, n) * 2.5).astype(np.float32) if classification else \
        rng.integers(0, 10, n).astype(np.float32)
    return x, y


def _port_from_jax_params(params, meta) -> treg.SimpleFCRegressor:
    return treg.regressor_from_params(
        [{k: np.asarray(v) for k, v in p.items()} for p in params],
        treg.RegressorMeta(**dataclasses.asdict(meta)), "cpu")


def _assert_params_close(jax_params, port: treg.SimpleFCRegressor, atol=1e-6):
    for p, q in zip(jax_params, port.params()):
        np.testing.assert_allclose(q["kernel"], np.asarray(p["kernel"]), atol=atol, rtol=0)
        np.testing.assert_allclose(q["bias"], np.asarray(p["bias"]), atol=atol, rtol=0)


def test_lr_schedule_matches_jax():
    jcfg, pcfg = _cfgs(lr=3e-4, min_lr=2e-6, restart_epochs=7)
    for e in range(40):
        assert ttrain._lr_at_epoch(e, pcfg) == jtrain._lr_at_epoch(e, jcfg)


@pytest.mark.parametrize("n,batch", [(30, 16), (32, 16), (5, 16), (17, 4)])
def test_pad_to_batches_matches_jax(n, batch):
    x, y = _data(n, n, False)
    got, want = ttrain._pad_to_batches(x, y, batch), jtrain._pad_to_batches(x, y, batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[0]) % batch == 0 and got[2].sum() == n


@pytest.mark.parametrize("head", ["regression", "classification"])
def test_training_run_matches_jax(tmp_path, head):
    """20 epochs of one batch from the JAX package's initial weights, no
    dropout: the parameters, the train and test losses and the third metric
    within 1e-6 of the JAX package's ``train_regressor``."""
    classification = head == "classification"
    x, labels = _data(1, 30, classification)
    jcfg, pcfg = _cfgs(n_epochs=20, batch_size=32, classification=classification)
    jmodel, jhist = jtrain.train_regressor(x, labels, jcfg, [MODEL], plot_dir=str(tmp_path),
                                           verbose=False)

    targets, class_values = ttrain._prepare_labels(labels, pcfg)
    test_idx, train_idx = ttrain._split(len(x), pcfg)
    meta = ttrain._make_meta(x, labels, pcfg, [MODEL], class_values)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmodel.meta)
    init = jreg.SimpleFCRegressor.create(jax.random.key(pcfg.random_seed), jmodel.meta)
    model = _port_from_jax_params(init.params, jmodel.meta)
    xp, yp, wp = ttrain._pad_to_batches(x[train_idx], targets[train_idx], pcfg.batch_size)
    n_classes = len(class_values) if classification else 0
    hist, lrs = ttrain._train_run(
        model, *(torch.from_numpy(a) for a in (xp, yp, wp)), torch.from_numpy(x[test_idx]),
        torch.from_numpy(targets[test_idx]), pcfg, n_classes, torch.Generator().manual_seed(0))
    assert lrs == jhist["lrs"]
    np.testing.assert_allclose(hist[0], jhist["train"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(hist[1], jhist["test"], atol=1e-6, rtol=0)
    _assert_params_close(jmodel.params, model)
    assert hist[0][-1] < hist[0][0]


@pytest.mark.parametrize("head", ["regression", "classification"])
def test_multibatch_epoch_matches_jax(head):
    """One epoch of 7 batches of 8 (two zero-weight padding rows shuffled in)
    in JAX's own permutation: the Adam steps, the rate and the mean batch
    loss within 1e-6 of the JAX ``_epoch_body``."""
    classification = head == "classification"
    x, labels = _data(2, 54, classification)
    _jcfg, pcfg = _cfgs(batch_size=8, classification=classification, weight_decay=1e-3)
    targets, class_values = ttrain._prepare_labels(labels, pcfg)
    n_classes = len(class_values) if classification else 0
    xp, yp, wp = ttrain._pad_to_batches(x, targets, pcfg.batch_size)
    meta = ttrain._make_meta(x, labels, pcfg, [MODEL], class_values)
    jmeta = jreg.RegressorMeta(**dataclasses.asdict(meta))
    params = jreg.SimpleFCRegressor.create(jax.random.key(9), jmeta).params
    model = _port_from_jax_params(params, jmeta)

    key = jax.random.key(11)
    lr = 1.5e-3
    opt = jtrain.make_optimizer(pcfg.weight_decay)
    jparams, _state, jloss = jtrain._epoch_body(
        params, opt.init(params), jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(wp),
        jnp.float32(lr), key, 0.0, pcfg.weight_decay, pcfg.batch_size, n_classes)
    _key, perm_key = jax.random.split(key)  # the permutation _epoch_body draws
    perm = torch.from_numpy(np.array(jax.random.permutation(perm_key, len(xp))))

    loss = ttrain._train_epoch(model, ttrain.make_optimizer(model, pcfg),
                               *(torch.from_numpy(a) for a in (xp, yp, wp)), perm, lr,
                               pcfg.batch_size, n_classes, None)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-6, rtol=0)
    _assert_params_close(jparams, model)
    moved = max(np.abs(q["kernel"] - np.asarray(p["kernel"])).max()
                for p, q in zip(params, model.params()))
    assert moved > 1e-3  # the epoch did train


def _write_dataset(base, n=24, with_store=True, seed=0):
    """A labelled dataset under base/data/mydata: a store (or sidecars) of
    ViT-Test/tiny embeddings (4 crops of 16, 22 stats) and the CSV, a few
    rows unlabelled, a few labelled rows with no features."""
    root = base / "data" / "mydata"
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    uuids = [f"{i:032x}" for i in range(n)]
    emb = rng.normal(0, 1, (n, 4, 16)).astype(np.float32)
    stats = rng.normal(0, 1, (n, 22)).astype(np.float32)
    if with_store:
        store = EmbeddingStore.create(str(root), MODEL, list(ALL_CROPS), 16, uuids[:-2],
                                      dtype="float32")
        store.write_rows(0, emb[:-2], stats[:-2])
        store.valid[3] = False
        store.flush()
    else:
        from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS

        for i, u in enumerate(uuids[:-2]):
            crops = dict(zip(ALL_CROPS, emb[i]))
            if i == 3:  # a sidecar without the subcrop: skipped
                crops.pop("subcrop2_0.1")
            write_sidecar(str(root / f"{u}.pt"), MODEL, crops,
                          dict(zip(IMG_STAT_KEYS, stats[i])))
    db = LabelDatabase.load_or_create(str(root))
    for i, u in enumerate(uuids):
        if i % 5 != 4:
            db.relabel(u, float(rng.integers(0, 10)))
    db.ensure_rows(uuids)
    db.save()
    return root


@pytest.mark.parametrize("source", ["store", "sidecars"])
@pytest.mark.parametrize("stats", [False, True])
def test_load_training_data_matches_jax(tmp_path, source, stats):
    """The same rows in the same order as the JAX function under the same
    global seed (pandas' sample(frac=1) is np.random.permutation there),
    with the same rows skipped and the models discovered from "all"."""
    _write_dataset(tmp_path, with_store=source == "store")
    args = (str(tmp_path / "data"), ["mydata"], ["all"], ["centre_crop", "subcrop2_0.1"],
            stats)
    np.random.seed(123)
    want = jtrain.load_training_data(*args)
    np.random.seed(123)
    got = ttrain.load_training_data(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == [MODEL]
    assert got[0].shape == (17, 32 + (22 if stats else 0))  # 20 labelled, 3 skipped
    np.random.seed(124)
    other = ttrain.load_training_data(*args)
    assert not np.array_equal(other[1], got[1]) or not np.array_equal(other[0], got[0])


def test_load_training_data_without_a_csv_raises(tmp_path):
    (tmp_path / "data" / "mydata").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="mydata.csv"):
        ttrain.load_training_data(str(tmp_path / "data"), ["mydata"], ["all"],
                                  ["centre_crop"], False)


@pytest.mark.parametrize("classification", [False, True])
def test_train_cli_writes_a_checkpoint_jax_reads(tmp_path, monkeypatch, classification):
    """The port's CLI on the CPU end to end: the JAX package's printed lines,
    a self-describing .npz under models/ (and the .pth with --export_torch),
    which the JAX package loads with the same scores."""
    _write_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--train_data_dir", str(tmp_path / "data"), "--train_data_names", "mydata",
            "--n_epochs", "4", "--batch_size", "4", "--hidden_sizes", "8", "4",
            "--print_network_layout", "--device", "cpu"]
    if classification:
        argv.append("--classification")
    else:
        argv.append("--export_torch")
    model, history, path = ttrain.main(argv)
    assert os.path.dirname(path) == "models" and "_imgs_4_epochs_" in path
    assert path.endswith("_xent.npz" if classification else "_mse.npz")
    assert history["steps"] == 4 * 4 and history["seconds"] > 0  # 13 rows: 4 batches
    assert len(history["train"]) == 4 and np.isfinite(history["train"]).all()
    back = jreg.SimpleFCRegressor.load(path)
    x = np.random.default_rng(0).normal(0, 0.3, (9, 32)).astype(np.float32)
    np.testing.assert_allclose(back.predict(x), model.predict(x), atol=1e-6)
    assert os.path.exists(path[:-4] + ".pth") != classification
    assert os.path.exists("training_progress.png") and os.path.exists("test_set_predictions.png")


def test_train_cli_refusals(tmp_path, monkeypatch):
    """The default device is the card, refused where there is none;
    --debug_nans is accepted, and on clean data it changes nothing."""
    _write_dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--train_data_dir", str(tmp_path / "data"), "--train_data_names", "mydata",
            "--n_epochs", "2", "--batch_size", "4", "--dont_save"]
    runs = [ttrain.main(argv + extra + ["--device", "cpu"]) for extra in ([], ["--debug_nans"])]
    for p, q in zip(runs[0][0].params(), runs[1][0].params()):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(p[k], q[k])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(argv)


def _nan_epoch(lr, nan_row, epoch):
    """One epoch of ``_train_epoch`` with --debug_nans on 16 rows in batches
    of 4 (the identity order), a NaN planted in feature row ``nan_row`` (or
    none)."""
    x, y = _data(3, 16, False)
    if nan_row is not None:
        x[nan_row, 5] = np.nan
    _jcfg, pcfg = _cfgs(batch_size=4)
    targets, _ = ttrain._prepare_labels(y, pcfg)
    meta = ttrain._make_meta(x, y, pcfg, [MODEL], None)
    model = treg.SimpleFCRegressor.create(meta, 0, "cpu")
    xp, yp, wp = ttrain._pad_to_batches(x, targets.astype(np.float32), 4)
    return ttrain._train_epoch(model, ttrain.make_optimizer(model, pcfg),
                               *(torch.from_numpy(a) for a in (xp, yp, wp)),
                               torch.arange(len(xp)), lr, 4, 0, None, debug_nans=True,
                               epoch=epoch)


@pytest.mark.parametrize("nan_row,epoch,step,where", [
    (9, 0, 2, "the loss"),
    (0, 4, 0, "the loss"),
    (None, 1, 0, "parameter linears.0.weight after the optimizer step"),
])
def test_debug_nans_names_the_epoch_and_step(nan_row, epoch, step, where):
    """The first non-finite loss (a NaN feature row in the step's batch), or
    parameter (a NaN learning rate: the step's loss is finite, its update is
    not), raises FloatingPointError naming the epoch and the step, 0-based."""
    lr = float("nan") if nan_row is None else 1e-3
    with pytest.raises(FloatingPointError) as err:
        _nan_epoch(lr, nan_row, epoch)
    assert str(err.value) == (f"debug_nans: non-finite value in {where} at epoch {epoch}, "
                              f"step {step}")


def test_debug_nans_off_is_bit_for_bit(tmp_path):
    """train_regressor with and without the flag on clean data: the same
    parameters and history, bit for bit; with it, a NaN in a training row
    stops the run in epoch 0."""
    x, y = _data(4, 30, False)
    _jcfg, pcfg = _cfgs(n_epochs=3, batch_size=4, dropout_prob=0.2)
    runs = [ttrain.train_regressor(x, y, pcfg, [MODEL], verbose=False, device="cpu",
                                   debug_nans=flag, plot_dir=str(tmp_path))
            for flag in (False, True)]
    for p, q in zip(runs[0][0].params(), runs[1][0].params()):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(p[k], q[k])
    for key in ("train", "test", "third"):
        np.testing.assert_array_equal(runs[0][1][key], runs[1][1][key])
    x[ttrain._split(len(x), pcfg)[1][0], 0] = np.nan  # a training row
    with pytest.raises(FloatingPointError, match="in the loss at epoch 0, step"):
        ttrain.train_regressor(x, y, pcfg, [MODEL], verbose=False, device="cpu",
                               debug_nans=True, plot_dir=str(tmp_path))


def test_plots_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing, training goes on and says which PNG it
    did not write."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    out = str(tmp_path / "training_progress.png")
    assert plots.plot_or_say(plots.plot_losses, [1.0], [1.0], [1e-3], out_path=out) is None
    assert f"matplotlib is not installed: {out} not written" in capsys.readouterr().out
    assert not os.path.exists(out)
    x, y = _data(3, 20, False)
    _jcfg, pcfg = _cfgs(n_epochs=2, batch_size=8)
    model, history = ttrain.train_regressor(x, y, pcfg, [MODEL], plot_dir=str(tmp_path),
                                            verbose=False, device="cpu")
    assert "test_set_predictions.png not written" in capsys.readouterr().out
    assert len(history["train"]) == 2
