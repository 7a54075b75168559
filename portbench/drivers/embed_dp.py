"""The generator of the data-parallel embed mixes: ``drivers/embed``'s pool,
set-up, whole passes and check, with the stage's loop (``pipeline/embed.
embed_batches``) driving ``parallel/embed_sharded.ShardedEmbedder`` over the
cell's cards (``parallel/mesh.get_mesh``, as the stage's ``_default_mesh``
builds it where a host has several): every batch split over the cards, the
tower replicated on each, the embeddings and stats gathered on the first.
int8_static calibrates once, on the first batch of the set-up."""
from __future__ import annotations

from portbench.drivers import embed, stage_loop


class ShardedStage(stage_loop.LoopStage):
    """The encoder's tower replicated over the cell's cards."""

    calibrate = True

    def __init__(self, run, paths: list[str], root: str):
        from clip_assisted_data_labeling_tpu_torch.models.encoders import calibration_file
        from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder
        from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh

        super().__init__(run, paths, root)
        enc, chips = self.encoder, run.workload["chips"]
        devices = None if run.device.type == "cuda" else [run.device] * chips
        self.embedder = ShardedEmbedder(
            enc.model, enc.cfg, get_mesh(chips, devices=devices), compute_dtype=enc.compute_dtype,
            parity_preprocess=enc.parity_preprocess,
            calibration_path=calibration_file(self.model_name, root),
            model_name=self.model_name)


def drive(run) -> None:
    stage_loop.drive(run, ShardedStage, embed._check)


control = embed.control
