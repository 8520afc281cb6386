"""Device kernels launched in the traced window per pair served."""


def read(s: dict):
    if s.get("mode") != "eval" or not s["pairs"]:
        return None
    return s["kernels"] / s["pairs"]
