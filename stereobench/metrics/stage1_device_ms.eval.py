"""Device time per pair of stage 1 of the volume pipeline (the /8 attention
volume, its hourglass, the propagation and the top-k planes), in eval cells,
in ms: the ``device_s`` of the program's ``stage1`` spans (the stream's time
from each span's entry event to its exit event) over the traced window,
whose pairs are the base.  None where the program opens no such span."""

SPAN, KEY, MODE = "stage1", "device_s", "eval"


def read(s: dict):
    if s.get("mode") != MODE or not s["pairs"]:
        return None
    try:
        from semstereo_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    value = trace.totals().get(SPAN, {}).get(KEY)
    return None if value is None else 1e3 * value / s["pairs"]
