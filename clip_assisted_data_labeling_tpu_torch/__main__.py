"""Package entry point: print the stage map."""
USAGE = """clip_assisted_data_labeling_tpu_torch — CLIP-assisted dataset labeling on NVIDIA GPUs (PyTorch/CUDA)

Pipeline stages (python -m clip_assisted_data_labeling_tpu_torch.pipeline.<stage>):
  prep            uuid-rename + normalize a raw image directory (host)
  embed           4-crop CLIP embeddings + image stats (GPU, hand-written kernels;
                  every tower of the open_clip surface: CLIP, SigLIP/SigLIP2
                  with naflex, PE, EVA, CoCa, CLIPA, the modified ResNets,
                  ConvNeXt)
  dedup           all-pairs near-duplicate removal (one GPU, or a ring over
                  every local GPU or every process's)
  label           interactive labeling UI (opencv or headless)
  train           FC regressor on (embedding -> label) pairs
  predict         score every image, update the CSV database
  loop            the active-learning cycle as one command:
                  label -> train -> predict -> re-sort, N laps
  subset          export a score-filtered subset (host)
  predict_simple  standalone per-image scorer
  store           columnar-store management (rebuild from sidecars / info; host)

Every stage that touches the device runs on cuda unless given --device cpu;
embed, dedup and predict --sharded use every local GPU, and embed and dedup
--distributed every process's (torch.distributed over gloo).

Tools (find_similar_imgs, svm_similarity, merge_datasets, move_subset_of_files,
fix_img_dir, investigate_embedding, train_latent_regressor): not ported yet;
the JAX package's clip_assisted_data_labeling_tpu.tools.<tool> run them.

Docs: README.md (the port's section), PERF.md, ROADMAP.md.
"""

if __name__ == "__main__":
    print(USAGE)
