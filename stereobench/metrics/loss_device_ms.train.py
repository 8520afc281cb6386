"""Device time per pair of the loss terms (``assemble_train_loss``), in
train cells, in ms: the ``device_s`` of the program's ``loss`` spans (the
stream's time from each span's entry event to its exit event) over the
traced window, whose pairs are the base.  None where the program opens no
such span."""

SPAN, KEY, MODE = "loss", "device_s", "train"


def read(s: dict):
    if s.get("mode") != MODE or not s["pairs"]:
        return None
    try:
        from semstereo_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    value = trace.totals().get(SPAN, {}).get(KEY)
    return None if value is None else 1e3 * value / s["pairs"]
