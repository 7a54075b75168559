"""Where the encoder finds its weights: for each layout of a ``--model_path``
the port picks the file the JAX package's ``CLIPImageEncoder._load_params``
picks and loads the same leaves, or raises where it raises — ``<name>.npz``,
a directory holding only ``model.safetensors``, two unrelated checkpoints
beside ``pytorch_model.bin``, a stem that contains the name, a
``.safetensors`` file as the path, and a directory whose checkpoints match
nothing; a ``<name>.orbax`` directory raises the port's pinned error; no
layout with a checkpoint in it falls to random init. Also the port's own
safetensors reader against the ``safetensors`` package. The state dicts are
synthetic PE-Test/tiny ones."""
import json
import logging
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from tests.test_torch_pe import _pe_state_dict

NAME = "PE-Test/tiny"
CFG = tvit.resolve_config(NAME)


def _sd(seed):
    return {k: v.contiguous() for k, v in
            _pe_state_dict(CFG, np.random.default_rng(seed)).items()}


@pytest.fixture()
def spy(monkeypatch):
    """Records the basename of every file each package loads or converts."""
    seen = {"jax": [], "port": []}

    def wrap(owner, attr, pkg):
        orig = getattr(owner, attr)

        def inner(*args):
            seen[pkg].append(os.path.basename(args[-1]))
            return orig(*args)

        monkeypatch.setattr(owner, attr, inner)

    wrap(jenc.CLIPImageEncoder, "_convert_torch_file", "jax")
    wrap(jenc.clip_weights, "load_params_npz", "jax")
    wrap(tenc.CLIPImageEncoder, "_convert_torch_file", "port")
    wrap(tenc.CLIPImageEncoder, "_load_npz", "port")
    return seen


def _both(path, caplog):
    """Both encoders from ``path`` in float32: (JAX flat leaves, port flat
    leaves), after checking that neither fell to random init."""
    with caplog.at_level(logging.WARNING):
        j = jenc.CLIPImageEncoder(NAME, model_path=path, compute_dtype=jnp.float32)
        t = tenc.CLIPImageEncoder(NAME, model_path=path, compute_dtype="float32", device="cpu")
    assert not any("random init" in r.getMessage() for r in caplog.records)
    want = tweights.flatten_params(jax.tree.map(np.asarray, j.params))
    return want, tweights.params_from_module(t.model)


def _layout(kind, d):
    """Writes one layout into directory d; returns (the --model_path, the
    file both packages must pick)."""
    if kind == "npz":
        params = jweights.convert_torch_state_dict(_sd(1), jenc.resolve_config(NAME))
        jweights.save_params_npz(os.path.join(d, "PE-Test-tiny.npz"), params)
        torch.save(_sd(2), os.path.join(d, "PE-Test-tiny.pt"))  # the .npz comes first
        return d, "PE-Test-tiny.npz"
    if kind == "only_safetensors":
        save_file(_sd(1), os.path.join(d, "model.safetensors"))
        return d, "model.safetensors"
    if kind == "standard_name_among_others":
        torch.save(_sd(2), os.path.join(d, "ckpt_A.pt"))
        torch.save(_sd(3), os.path.join(d, "ckpt_B.pt"))
        torch.save(_sd(1), os.path.join(d, "pytorch_model.bin"))
        return d, "pytorch_model.bin"
    if kind == "substring_stem":
        torch.save(_sd(2), os.path.join(d, "other.pt"))
        save_file(_sd(1), os.path.join(d, "PE-Test-tiny_finetuned.safetensors"))
        return d, "PE-Test-tiny_finetuned.safetensors"
    if kind == "arch_stem":
        torch.save(_sd(2), os.path.join(d, "open_clip_pytorch_model.bin"))
        torch.save(_sd(1), os.path.join(d, "PE-Test.pth"))
        return d, "PE-Test.pth"
    if kind == "safetensors_file":
        path = os.path.join(d, "weights.safetensors")
        save_file(_sd(1), path)
        return path, "weights.safetensors"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["npz", "only_safetensors", "standard_name_among_others",
                                  "substring_stem", "arch_stem", "safetensors_file"])
def test_lookup_picks_and_loads_as_jax(tmp_path, caplog, spy, kind):
    path, pick = _layout(kind, str(tmp_path))
    want, got = _both(path, caplog)
    assert spy["jax"] == spy["port"] == [pick]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_unmatched_checkpoints_raise_as_jax(tmp_path):
    """Checkpoints, none of this model's and no standard name: a lookup miss
    that raises in both, with the same message."""
    torch.save(_sd(1), str(tmp_path / "ckpt_A.pt"))
    save_file(_sd(2), str(tmp_path / "ckpt_B.safetensors"))
    with pytest.raises(FileNotFoundError) as want:
        jenc.CLIPImageEncoder(NAME, model_path=str(tmp_path), compute_dtype=jnp.float32)
    with pytest.raises(FileNotFoundError) as got:
        tenc.CLIPImageEncoder(NAME, model_path=str(tmp_path), compute_dtype="float32",
                              device="cpu")
    assert str(got.value) == str(want.value)


def test_orbax_directory_raises_the_pinned_error(tmp_path, caplog):
    """A '<name>.orbax' checkpoint needs JAX's orbax: the port names the
    conversion to .npz through the JAX package and never falls to random
    init, even with other checkpoints beside it."""
    os.makedirs(tmp_path / "PE-Test-tiny.orbax")
    torch.save(_sd(1), str(tmp_path / "pytorch_model.bin"))
    with caplog.at_level(logging.WARNING), pytest.raises(ValueError) as err:
        tenc.CLIPImageEncoder(NAME, model_path=str(tmp_path), compute_dtype="float32",
                              device="cpu")
    orbax, npz = str(tmp_path / "PE-Test-tiny.orbax"), str(tmp_path / "PE-Test-tiny.npz")
    assert str(err.value) == tenc.ORBAX_NEEDS_JAX.format(path=orbax, npz=npz)
    for part in ("load_params_orbax", "save_params_npz", f"--model_path {npz}"):
        assert part in str(err.value)
    assert not any("random init" in r.getMessage() for r in caplog.records)


def test_empty_directory_and_no_path_take_random_init(tmp_path, caplog):
    """Only a directory without checkpoints, or no path, reaches random init,
    with the JAX package's warning."""
    (tmp_path / "notes.txt").write_text("no weights here")
    for path in (str(tmp_path), None):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            tenc.CLIPImageEncoder(NAME, model_path=path, compute_dtype="float32", device="cpu")
        assert any("No local weights found for PE-Test/tiny" in r.getMessage()
                   for r in caplog.records)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tenc.CLIPImageEncoder(NAME, model_path=str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_own_safetensors_reader_matches_the_package(tmp_path, monkeypatch, dtype):
    """With ``safetensors`` hidden, ``load_safetensors`` reads the file
    itself: the package's values (bf16 as float32), shapes and names."""
    gen = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn((3, 5), generator=gen).to(dtype),
          "b": torch.randn((7,), generator=gen).to(dtype),
          "c.idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "d.scalar": torch.tensor(2.5).to(dtype)}
    path = str(tmp_path / "w.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    want = load_file(path)
    for mod in ("safetensors", "safetensors.torch"):
        monkeypatch.setitem(sys.modules, mod, None)
    got = tweights.load_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        torch.testing.assert_close(got[k], v.float() if v.dtype == torch.bfloat16 else v,
                                   rtol=0, atol=0)


def test_own_safetensors_reader_refuses_other_dtypes(tmp_path):
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    path = str(tmp_path / "f8.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header.encode() + b"\x00\x01")
    with pytest.raises(ValueError, match="F8_E4M3"):
        tweights._read_safetensors(path)
