"""Share of the traced window in which no operation ran on the card, in
train cells: 1 - (union of device operation intervals) / window."""


def read(s: dict):
    if s.get("mode") != "train" or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
