"""The port's train step trains: the counterpart of the JAX package's
``test_loss_decreases`` (tests/test_train_integration.py), on the CPU.

Its tiny config (maxdisp 16, topk 4, attention windows (1, 2, 2), seg and
LRSC losses, lr 1e-3) takes 8 steps of one synthetic 32x32 batch of 2 from
the seeded fp32 initial state: every loss is finite and the last is below
the first, as JAX holds it (measured on the CPU: 36.55 falling to 10.67).
Its 200-step bf16-against-fp32 check runs on the card
(``chip_smoke.py``'s bf16 curves phase).
"""

import numpy as np

from semstereo_tpu_torch.config import DataConfig, LossConfig, ModelConfig, OptimConfig, TrainConfig
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.train import init_state, make_train_step
from tests._torch_threads import two_torch_threads  # noqa: F401

TINY = TrainConfig(
    model=ModelConfig(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2)),
    data=DataConfig(batch_size=2),
    optim=OptimConfig(lr=1e-3),
    loss=LossConfig(use_seg=True, use_lrsc=True),
)


def test_loss_decreases():
    state = init_state(TINY, device="cpu")
    step = make_train_step(TINY)
    batch = SyntheticStereoDataset(2, 32, 32, 16).batch(0, 2)
    losses = [float(step(state, batch)["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
