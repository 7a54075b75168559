"""The native-aspect path on the port's block route with per-image key
lengths, on the CPU: the attention kernels' plain versions given lengths
against each sequence alone, the forward (``naflex_encode`` on the route, on
a ragged batch and on each image alone, ``CLIPImageEncoder.encode_variable``)
against the
benchmark's plain reference (``portbench/reference/naflex.py``) at two patch
caps and three aspects in one ragged batch, the loader's ``native`` option
and the embed CLI's ``--max_patches``. The kernels themselves run on the
card only (``tests/test_torch_cuda.py``)."""
import json
import os
import time

import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
from clip_assisted_data_labeling_tpu_torch.data.png import write_png
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import naflex as tnaflex
from clip_assisted_data_labeling_tpu_torch.ops import attention as tattn
from clip_assisted_data_labeling_tpu_torch.pipeline import embed as tembed
from clip_assisted_data_labeling_tpu_torch.utils import timer
from portbench import weights
from portbench.reference import naflex as ref_naflex
from portbench.reference import tf32

NAME = "SigLIP2-Naflex-Test/tiny"
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "portbench", "configs", "siglip2_so400m16_naflex.json")
# one batch of the three aspects 1:1, 2:3 and 3:1 (uint8 [H, W, 3])
ASPECTS = [(48, 48), (60, 40), (30, 90)]


def tiny_config() -> dict:
    """The benchmark configuration's keys at the port's tiny naflex tower."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_naflex", model_name=NAME, width=64, layers=2, heads=4, head_dim=16,
               mlp_dim=224, patch_size=8, image_size=32, seq_len=16, embed_dim=64,
               pool_heads=4, position_grid=4, max_patches=64)
    return cfg


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ASPECTS]


def _reference(params, cfg, imgs, max_patches):
    with tf32(False), torch.inference_mode():
        return torch.stack([ref_naflex.encode_native(params, cfg, torch.from_numpy(im), max_patches)
                            for im in imgs]).numpy()


def _cos_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    return float((1.0 - cos).max())


# ---- the plain kernels given per-sequence lengths ------------------------------

PLAIN = {"K1": tattn.fused_attention_packed_plain, "K4": tattn.fused_attention_packed_grouped_plain,
         "K5": tattn.flash_attention_packed_plain, "auto": tattn.packed_attention_auto}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(PLAIN))
@pytest.mark.parametrize("s,lengths", [(50, [50, 1, 33, 49]), (800, [800, 700, 369, 5])])
def test_plain_lengths_equal_each_sequence_alone(kernel, dtype, s, lengths):
    """Each sequence's rows given its length in a batch equal the same
    function on that sequence alone with ``s_real`` = its length (K5's panel
    boundaries come from S either way); its rows past the length are zeros."""
    w, heads = 64, 4
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.normal(0, 1, (len(lengths), s, 3 * w)).astype(np.float32)).to(dtype)
    kv_len = torch.tensor(lengths, dtype=torch.int32)
    got = PLAIN[kernel](qkv, heads, 0.25, kv_len)
    assert not torch.isnan(got).any()
    for bi, n in enumerate(lengths):
        alone = PLAIN[kernel](qkv[bi: bi + 1], heads, 0.25, n)
        assert torch.equal(got[bi, :n], alone[0, :n]), (bi, n)
        assert torch.count_nonzero(got[bi, n:]).item() == 0


def test_plain_lengths_against_per_sequence_attention():
    """Against attention written out per sequence on its n tokens alone
    (float64 softmax(q·kᵀ·scale)·v): the lengths leave no padded key in."""
    w, heads, lengths = 64, 4, [40, 17, 3]
    d = w // heads
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(0, 1, (3, 40, 3 * w)).astype(np.float32))
    got = tattn.packed_attention_auto(qkv, heads, d ** -0.5,
                                      torch.tensor(lengths, dtype=torch.int32))
    for bi, n in enumerate(lengths):
        q, k, v = (t.double().reshape(n, heads, d).transpose(0, 1)
                   for t in qkv[bi, :n].split(w, dim=-1))
        want = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1) @ v
        np.testing.assert_allclose(got[bi, :n].numpy(), want.transpose(0, 1).reshape(n, w).numpy(),
                                   atol=1e-5)


def test_lengths_are_checked():
    qkv = torch.zeros((2, 8, 12))
    for bad in (torch.tensor([8, 3]), torch.tensor([8], dtype=torch.int32)):
        with pytest.raises(ValueError, match="per-sequence lengths"):
            tattn._check_packed("x", qkv, 2, bad, (torch.float32,))
    tattn._check_packed("x", qkv, 2, torch.tensor([8, 3], dtype=torch.int32), (torch.float32,))


def test_grouped_route_lengths_go_to_k1(monkeypatch):
    """Where the route rule picks the grouped kernel (K4), lengths go to K1,
    which computes the same function and takes them."""
    calls = []
    monkeypatch.setattr(tattn, "attention_route", lambda *a: "grouped")
    monkeypatch.setattr(tattn, "fused_attention_packed",
                        lambda *a, **k: calls.append("K1") or "k1")
    monkeypatch.setattr(tattn, "fused_attention_packed_grouped",
                        lambda *a, **k: calls.append("K4") or "k4")
    qkv = torch.zeros((2, 8, 12))
    tattn.packed_attention_auto(qkv, 2, 0.5, torch.tensor([8, 3], dtype=torch.int32))
    tattn.packed_attention_auto(qkv, 2, 0.5, 8)
    assert calls == ["K1", "K4"]


# ---- the forward against the plain reference -----------------------------------

@pytest.mark.parametrize("max_patches", [16, 64])
@pytest.mark.parametrize("alone", [True, False])
def test_naflex_encode_matches_reference_float32(alone, max_patches):
    """float32, on the block route with lengths (the card's route, on the
    plain kernels): within 1e-5 (1 − cosine) of the reference, which runs
    each image alone at its own length, both for the three aspects as one
    ragged batch (three lengths) and for each image as a batch of one."""
    cfg = tiny_config()
    params = weights.vit_params(cfg, 2**31 + 7, "cpu")
    enc = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32", device="cpu")
    imgs = _images()
    prepped = [tnaflex.preprocess_variable(im, enc.cfg, max_patches) for im in imgs]
    grids = [g for _p, _m, g in prepped]
    assert len({gh * gw for gh, gw in grids}) > 1  # ragged

    def encode(rows):
        return tnaflex.naflex_encode(
            enc.model, torch.from_numpy(np.stack([p for p, _m, _g in rows])),
            torch.from_numpy(tnaflex.build_pos_weights([g for _p, _m, g in rows], max_patches,
                                                       enc.cfg.grid)),
            torch.from_numpy(np.stack([m for _p, m, _g in rows])), torch.float32).numpy()

    got = np.concatenate([encode([r]) for r in prepped]) if alone else encode(prepped)
    assert _cos_err(got, _reference(params, cfg, imgs, max_patches)) <= 1e-5


# bfloat16 rounds every product's operands and every activation to 8
# mantissa bits (a relative step of 2^-8); through the tiny tower's two
# blocks and MAP head the embedding's 1 − cosine against float32 read
# 2.4e-5 to 8.7e-5 over ten seeded draws at both caps. 1e-3 is the limit the
# port's other bf16 paths are held to against the JAX package (PERF.md §2);
# a padded key left in the softmax moves these rows by far more (the
# harness's planted fault, tests/test_torch_naflex_bench.py).
BF16_LIMIT = 1e-3


@pytest.mark.parametrize("max_patches", [16, 64])
def test_encode_variable_matches_reference(max_patches):
    """``encode_variable(images, max_patches)`` in float32 within 1e-5 of the
    reference, and in bfloat16 (the block route with lengths) within
    BF16_LIMIT; ``encode_patches`` on the loader's arrays gives the same."""
    cfg = tiny_config()
    params = weights.vit_params(cfg, 2**31 + 9, "cpu")
    imgs = _images(1)
    ref = _reference(params, cfg, imgs, max_patches)
    f32 = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32", device="cpu")
    assert _cos_err(f32.encode_variable(imgs, max_patches).numpy(), ref) <= 1e-5
    bf16 = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="bfloat16", device="cpu")
    prepped = [tnaflex.preprocess_variable(im, bf16.cfg, max_patches) for im in imgs]
    via_patches = bf16.encode_patches(np.stack([p for p, _m, _g in prepped]),
                                      np.stack([m for _p, m, _g in prepped]),
                                      [g for _p, _m, g in prepped])
    blocks = []
    real = tnaflex._block_generic
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnaflex, "_block_generic",
                   lambda *a, **k: blocks.append(k["s_real"].tolist()) or real(*a, **k))
        got = tnaflex.naflex_encode(
            bf16.model, torch.from_numpy(np.stack([p for p, _m, _g in prepped])),
            torch.from_numpy(tnaflex.build_pos_weights([g for _p, _m, g in prepped], max_patches,
                                                       bf16.cfg.grid)),
            torch.from_numpy(np.stack([m for _p, m, _g in prepped])), torch.bfloat16)
    lengths = [gh * gw for _p, _m, (gh, gw) in prepped]
    assert blocks == [lengths] * bf16.cfg.layers
    assert _cos_err(got.numpy(), ref) <= BF16_LIMIT
    np.testing.assert_array_equal(via_patches.numpy(),
                                  bf16.encode_variable(imgs, max_patches).numpy())


def test_default_cap_is_the_square_grid():
    """``encode_variable`` without ``max_patches`` takes the tower's square
    grid (256 patches for SO400M/16, HF's default; 16 for the tiny tower)."""
    cfg = tiny_config()
    params = weights.vit_params(cfg, 3, "cpu")
    enc = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32", device="cpu")
    imgs = _images(2)
    np.testing.assert_array_equal(enc.encode_variable(imgs).numpy(),
                                  enc.encode_variable(imgs, 16).numpy())


def test_reference_pieces():
    """The reference's grid search, PIL copy and position resize against the
    port's (each written independently)."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(8, 3000, 2))
        p, m = int(rng.choice([8, 14, 16])), int(rng.choice([16, 64, 256, 1024]))
        assert ref_naflex.target_grid(h, w, p, m) == tnaflex.target_grid(h, w, p, m)
    img = rng.integers(0, 256, (70, 130, 3), dtype=np.uint8)
    for size in ((64, 48), (256, 200), (130, 16)):
        np.testing.assert_array_equal(
            ref_naflex.pil_bilinear(torch.from_numpy(img), *size).numpy(),
            tnaflex.pil_bilinear_resize(img, *size))
    table = torch.from_numpy(rng.normal(0, 1, (256, 8)).astype(np.float32))
    for grid in ((32, 32), (26, 39), (42, 24), (7, 3)):
        want = torch.from_numpy(tnaflex.pos_resize_weights(*grid, 16)) @ table
        torch.testing.assert_close(ref_naflex.position_table(table, grid), want, atol=1e-5,
                                   rtol=1e-5)


# ---- the loader's workers and the CLI ---------------------------------------------

def test_loader_prepares_native_rows_in_its_workers(tmp_path):
    """``native``: each batch carries the function's outputs for its images,
    cut back off their canvases, and a ``naflex_prep`` span an image."""
    cfg = tenc.CLIPImageEncoder(NAME, compute_dtype="float32", device="cpu").cfg
    paths = []
    for i, (h, w) in enumerate([(40, 40), (90, 30), (30, 90), (200, 100)]):
        paths.append(str(tmp_path / f"im{i}.png"))
        write_png(paths[-1], np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8))
    prep = tembed.native_prep(cfg, 64)
    since = time.perf_counter()
    batches = list(BatchedImageLoader(paths, canvas_size=128, out_size=32, batch_size=3,
                                      num_workers=2, use_native=False, native=prep))
    spans = [s for s in timer.recorded(since) if s.name == "naflex_prep"]
    assert sum(s.items for s in spans) == len(paths)
    for b in batches:
        patches, masks, grids = b.native
        assert patches.shape == (b.n_valid, 64, 8 * 8 * 3) and len(grids) == b.n_valid
        for i in range(b.n_valid):
            ox, oy, w, h = (int(v) for v in b.stat_params[i, :4])
            p, m, g = tnaflex.preprocess_variable(b.canvas[i, oy: oy + h, ox: ox + w], cfg, 64)
            np.testing.assert_array_equal(patches[i], p)
            np.testing.assert_array_equal(masks[i], m)
            assert grids[i] == g


def test_embed_cli_max_patches(tmp_path):
    """``--aspect native --max_patches 64`` on the CPU: the fifth column of
    every image is the encoder's ``encode_variable`` at 64 patches of its
    canvas pixels."""
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

    root = tmp_path / "ds"
    root.mkdir()
    for i, (h, w) in enumerate([(40, 40), (90, 30), (30, 90)]):
        write_png(str(root / f"im{i}.png"),
                  np.random.default_rng(10 + i).integers(0, 256, (h, w, 3), dtype=np.uint8))
    tembed.main(["--root_dir", str(root), "--models_to_use", NAME, "--compute_dtype", "float32",
                 "--aspect", "native", "--max_patches", "64", "--canvas_size", "128",
                 "--batch_size", "2", "--num_workers", "2", "--device", "cpu"])
    store = EmbeddingStore.open(str(root), NAME)
    assert store.meta["crop_names"][-1] == "native_aspect"
    enc = tenc.CLIPImageEncoder(NAME, compute_dtype="float32", device="cpu")
    batch = next(iter(BatchedImageLoader(sorted(str(p) for p in root.glob("*.png")),
                                         canvas_size=128, out_size=32, batch_size=3,
                                         num_workers=1, use_native=False)))
    imgs = []
    for i in range(batch.n_valid):
        ox, oy, w, h = (int(v) for v in batch.stat_params[i, :4])
        imgs.append(batch.canvas[i, oy: oy + h, ox: ox + w])
    want = enc.encode_variable(imgs, 64).numpy()
    rows = [store.index_of(os.path.splitext(os.path.basename(p))[0]) for p in batch.paths]
    got = np.asarray(store.embeddings, np.float32)[rows, -1]
    assert _cos_err(got, want) <= 1e-5  # the store's float16 rounding
