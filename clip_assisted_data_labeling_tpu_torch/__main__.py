"""Package entry point: print the stage map."""
USAGE = """clip_assisted_data_labeling_tpu_torch — CLIP-assisted dataset labeling on NVIDIA GPUs (PyTorch/CUDA)

Pipeline stages (python -m clip_assisted_data_labeling_tpu_torch.pipeline.<stage>):
  prep            uuid-rename + normalize a raw image directory (host)
  embed           4-crop CLIP embeddings + image stats (GPU, hand-written kernels;
                  every ViT-trunk tower: CLIP, SigLIP/SigLIP2 with naflex, PE,
                  EVA, CoCa, CLIPA — ResNet and ConvNeXt not ported yet)
  dedup           all-pairs near-duplicate removal (one GPU)
  label           interactive labeling UI (opencv or headless)
  train           FC regressor on (embedding -> label) pairs
  predict         score every image, update the CSV database
  loop            the active-learning cycle as one command:
                  label -> train -> predict -> re-sort, N laps
  subset          export a score-filtered subset (host)
  predict_simple  standalone per-image scorer
  store           columnar-store management (rebuild from sidecars / info; host)

Every stage that touches the device runs on cuda unless given --device cpu.

Flags not ported yet, refused:
  embed    --host_count > 1, --distributed
  dedup    --distributed
  train    --debug_nans
  predict  --sharded

Tools (find_similar_imgs, svm_similarity, merge_datasets, move_subset_of_files,
fix_img_dir, investigate_embedding, train_latent_regressor): not ported yet;
the JAX package's clip_assisted_data_labeling_tpu.tools.<tool> run them.

Docs: README.md (the port's section), PERF.md, ROADMAP.md.
"""

if __name__ == "__main__":
    print(USAGE)
