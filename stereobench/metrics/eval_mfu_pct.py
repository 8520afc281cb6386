"""The eval step's share of the card's bf16 peak: the reference's
convolution and matrix-product operations per pair times the pairs per
second of the window before the trace, over the peak."""


def read(s: dict):
    if s.get("mode") != "eval" or not s.get("model_flop_per_pair"):
        return None
    return 100.0 * s["model_flop_per_pair"] * s["rate_pairs_per_s"] / s["peak_flops"]
