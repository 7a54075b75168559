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

Every stage and tool that touches the device, and the dry run, runs on cuda
unless given --device cpu; embed, dedup and predict --sharded use every local
GPU, and embed and dedup --distributed every process's (torch.distributed
over gloo).

Tools (python -m clip_assisted_data_labeling_tpu_torch.tools.<tool>):
  find_similar_imgs       top-N images nearest a context set's mean embedding (GPU)
  svm_similarity          top-N images by a balanced linear SVM's margin (GPU)
  train_latent_regressor  prompt-latent -> score regressor (GPU)
  merge_datasets          merge datasets into labeled/unlabeled splits (host)
  move_subset_of_files    copy a seeded random fraction of a dataset (host)
  fix_img_dir             quarantine unreadable images (host)
  investigate_embedding   print a .pt sidecar's structure (host)

Dry run (python -m clip_assisted_data_labeling_tpu_torch.dryrun --n_devices N):
the multi-device sequence (data and tensor parallel embed, the ring dedup, a
data-parallel regressor step, sharded predict) on tiny towers, each step
against one device; dryrun.entry() is the flagship ViT-L-14 embed step.

Docs: README.md (the port's section), PERF.md, ROADMAP.md.
"""

if __name__ == "__main__":
    print(USAGE)
