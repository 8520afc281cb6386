"""Device kernels launched in the traced window per pair trained."""


def read(s: dict):
    if s.get("mode") != "train" or not s["pairs"]:
        return None
    return s["kernels"] / s["pairs"]
