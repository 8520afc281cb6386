"""The gwc layer's share of its roofline in train cells: the least time
of its calls in the traced window (``work.py``) over the device time of
the operations launched inside them."""


def read(s: dict):
    layer = s.get("layers", {}).get("gwc")
    if s.get("mode") != "train" or not layer or layer["kernel_s"] <= 0:
        return None
    return 100.0 * layer["bound_s"] / layer["kernel_s"]
