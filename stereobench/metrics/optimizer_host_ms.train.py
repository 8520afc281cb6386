"""Host time per pair of the optimizer (the gradients' all-reduce, the clip
and Adam), in train cells, in ms: the ``host_s`` of the program's
``optimizer`` spans over the traced window, whose pairs are the base.  None
where the program opens no such span."""

SPAN, KEY, MODE = "optimizer", "host_s", "train"


def read(s: dict):
    if s.get("mode") != MODE or not s["pairs"]:
        return None
    try:
        from semstereo_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    value = trace.totals().get(SPAN, {}).get(KEY)
    return None if value is None else 1e3 * value / s["pairs"]
