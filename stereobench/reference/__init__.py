"""The plain reference of the benchmark: SemStereo, its train losses and
Adam in plain PyTorch (``model.py``, ``train.py``), and the control's fp8
computation (``precision.py``).  Nothing here imports the port."""

from stereobench.reference.model import SemStereo
from stereobench.reference.train import Adam, losses


def build(model_cfg: dict, precision=None, lean=False) -> SemStereo:
    """The reference network of a configuration's ``model`` fields."""
    return SemStereo(maxdisp=model_cfg["maxdisp"], num_classes=model_cfg["num_classes"],
                     att_weights_only=model_cfg["att_weights_only"],
                     symmetric=model_cfg["name"] != "SemStereo_WHU", topk=model_cfg["topk"],
                     refine_topk=model_cfg["refine_topk"],
                     att_window1=model_cfg["att_window1"], att_window2=model_cfg["att_window2"],
                     precision=precision, lean=lean)


__all__ = ["SemStereo", "Adam", "build", "losses"]
