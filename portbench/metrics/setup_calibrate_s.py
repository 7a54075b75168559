"""setup_calibrate_s: seconds of set-up in the port's ``calibrate`` spans (the
int8_static calibration forward on the first batch,
``CLIPImageEncoder._maybe_calibrate``): those that ended before the window,
read from the port's span log (``utils/timer.recorded``). None where the port
records no such span, or where its log dropped a record since the process
started."""


def read(run):
    from clip_assisted_data_labeling_tpu_torch.utils import timer

    recorded = getattr(timer, "recorded", None)
    if recorded is None or run.setup_s is None:
        return None
    spans = recorded(run.t_start)
    if spans is None:
        return None
    window = run.t_start + run.setup_s
    mine = [s for s in spans if s.name == "calibrate" and s.end < window]
    return sum(s.end - s.start for s in mine) if mine else None
