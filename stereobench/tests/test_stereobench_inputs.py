"""The traffic and the weights are the same for one seed and differ for another."""

import torch

from conftest import tiny_cell
from stereobench import inputs, weights

SEED = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def _pool(seed):
    c = tiny_cell("us3d_s2_train_b4", batch=2)
    return inputs.pairs(c.traffic, c.model["num_classes"], seed, "cpu")


def test_traffic_is_the_seeds():
    a, b, other = _pool(SEED), _pool(SEED), _pool(SEED + 1)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["right"], other[0]["right"])
    assert [x["left"].shape for x in a] == [x["left"].shape for x in other]


def test_pairs_are_rolled_views_with_their_ground_truth():
    for batch in _pool(SEED):
        for left, right, disp, label in zip(batch["left"], batch["right"], batch["disparity"],
                                            batch["label"]):
            d = int(disp[0, 0])
            assert -8 <= d < 8 and torch.equal(left, torch.roll(right, d, dims=1))
            assert torch.all(disp == d) and torch.all(label == label[0, 0])
            assert 0 <= label[0, 0] < 5
        assert torch.equal(batch["disparity_4"], batch["disparity"][:, ::4, ::4])


def test_weights_are_the_seeds():
    m = tiny_cell("us3d_s2_eval_b1").model
    a, b = weights.make_state_dict(m, SEED, "cpu"), weights.make_state_dict(m, SEED, "cpu")
    other = weights.make_state_dict(m, SEED + 1, "cpu")
    assert a.keys() == b.keys() == other.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classif.2.weight"], other["classif.2.weight"])


def test_weights_have_the_stated_statistics():
    sd = weights.make_state_dict(tiny_cell("us3d_s2_eval_b1").model, SEED, "cpu")
    var = torch.cat([v for k, v in sd.items() if k.endswith("running_var")])
    assert 0.5 <= var.min() and var.max() <= 1.5 and var.std() > 0.2
    assert sd["gamma"].item() == 0.0 and sd["beta"].item() == 2.0
    w = sd["hourglass.conv2.0.0.weight"]  # 64 -> 64, 3x3x3: sqrt(2 / (27 * 64))
    assert abs(w.std().item() / (2 / (27 * 64)) ** 0.5 - 1) < 0.05
    ratio = sd["classif.2.weight"].std() / (2 / 27) ** 0.5
    assert abs(ratio.item() / 8 - 1) < 0.1
