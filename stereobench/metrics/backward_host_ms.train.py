"""Host time per pair of autograd's backward from the loss, in train cells,
in ms: the ``host_s`` of the program's ``backward`` spans over the traced
window, whose pairs are the base.  None where the program opens no such
span."""

SPAN, KEY, MODE = "backward", "host_s", "train"


def read(s: dict):
    if s.get("mode") != MODE or not s["pairs"]:
        return None
    try:
        from semstereo_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    value = trace.totals().get(SPAN, {}).get(KEY)
    return None if value is None else 1e3 * value / s["pairs"]
