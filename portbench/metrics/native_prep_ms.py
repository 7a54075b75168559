"""native_prep_ms: milliseconds an image in the port's ``naflex_prep`` spans
that started in the window (a decode worker's preparation of one image's
native-aspect row: the aspect-preserving grid, PIL's bilinear resize, the
normalization and the patches, ``data/loader``'s ``native`` option), read
from the port's span log (``utils/timer.recorded``). The threads' seconds
are summed, so it reads how busy they were, not the wall clock. None where
the port records no such span, or where its log dropped a record of the
window."""


def read(run):
    from clip_assisted_data_labeling_tpu_torch.utils import timer

    recorded = getattr(timer, "recorded", None)
    if recorded is None or run.setup_s is None:
        return None
    window = run.t_start + run.setup_s
    spans = recorded(window)
    if spans is None:
        return None
    mine = [s for s in spans if s.name == "naflex_prep" and s.start >= window]
    items = sum(s.items for s in mine)
    return 1e3 * sum(s.end - s.start for s in mine) / items if items else None
