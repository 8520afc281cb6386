"""``semstereo_tpu_torch.trace``: the spans at the port's layer boundaries.

* Off (the default), ``span`` returns the one shared null context, records
  nothing and allocates nothing.
* On, spans nest with the right parents, share their root's request id,
  and a span's self time is its host time less its children's.
* The tiny model (64x64, maxdisp 16) gives an eval forward and a train
  step whose outputs are bitwise equal with spans on and off, and the span
  tree of the program: ``forward`` > ``front`` x 2, ``stage1``, ``stage2``
  in eval; ``step`` > (``forward`` > ...), ``loss``, ``backward``,
  ``optimizer`` in train.
* Under ``torch.profiler`` the record turns on by itself, and the exported
  trace holds the ``semstereo:`` ranges.
* On the card: every span has a positive ``device_s``, no longer than its
  parent's.
"""

import json
import time
import tracemalloc

import pytest
import torch

from semstereo_tpu_torch import trace
from semstereo_tpu_torch.config import ModelConfig, TrainConfig
from semstereo_tpu_torch.data import SyntheticStereoDataset
from semstereo_tpu_torch.models import build_model
from semstereo_tpu_torch.train import init_state, make_train_step

try:
    from tests._torch_threads import two_torch_threads  # noqa: F401
except ImportError:  # an installed package named ``tests`` shadows this directory
    pass

S = 64
MODEL = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))
# (name, index of the parent) in the order the spans open
EVAL_TREE = [("forward", None), ("front", 0), ("front", 0), ("stage1", 0), ("stage2", 0)]
TRAIN_TREE = [("step", None), ("forward", 0), ("front", 1), ("front", 1), ("stage1", 1),
              ("stage2", 1), ("loss", 0), ("backward", 0), ("optimizer", 0)]


@pytest.fixture(autouse=True)
def clean_record():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _tree(spans):
    return [(s["name"], s["parent"]) for s in spans]


def test_off_path_returns_the_shared_null_context_and_allocates_nothing():
    assert trace.span("forward") is trace.span("step") is trace._NULL
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("front"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only_trace = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(only_trace).compare_to(before.filter_traces(only_trace),
                                                       "lineno")
    assert [d for d in grown if d.size_diff > 0] == []
    assert trace.spans() == [] and trace.totals() == {}


def test_spans_nest_share_their_root_id_and_give_self_time():
    trace.enable()
    with trace.span("step"):
        with trace.span("forward"):
            with trace.span("front"):
                time.sleep(0.002)
            time.sleep(0.002)
        with trace.span("backward"):
            time.sleep(0.002)
    with trace.span("forward"):
        pass
    spans = trace.spans()
    assert _tree(spans) == [("step", None), ("forward", 0), ("front", 1), ("backward", 0),
                            ("forward", None)]
    assert [s["request"] for s in spans] == [0, 0, 0, 0, 1]
    assert all(s["device_s"] is None for s in spans)  # no events on the CPU
    for s in spans:
        assert s["host_s"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e9)
    step, fwd, front, bwd, fwd2 = spans
    assert fwd["start_ns"] >= step["start_ns"] and bwd["end_ns"] <= step["end_ns"]
    t = trace.totals()
    assert t["forward"]["count"] == 2 and t["step"]["count"] == 1
    assert t["forward"]["host_s"] == pytest.approx(fwd["host_s"] + fwd2["host_s"])
    assert t["step"]["self_host_s"] == pytest.approx(step["host_s"] - fwd["host_s"]
                                                     - bwd["host_s"])
    assert t["forward"]["self_host_s"] == pytest.approx(t["forward"]["host_s"]
                                                        - front["host_s"])
    assert t["front"]["self_host_s"] == pytest.approx(front["host_s"])
    assert t["forward"]["self_host_s"] >= 0.002 > 0 and t["step"]["device_s"] is None


def test_reset_empties_the_record_and_refuses_inside_a_span():
    trace.enable()
    with trace.span("step"):
        with pytest.raises(RuntimeError, match="open span 'step'"):
            trace.reset()
    assert len(trace.spans()) == 1
    trace.reset()
    assert trace.spans() == [] and trace.totals() == {}
    with trace.span("forward"):
        pass
    assert trace.spans()[0]["request"] == 0


def test_the_record_keeps_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("forward"):
            pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2
    trace.reset()
    assert trace.dropped() == 0


def test_the_profiler_turns_the_record_on_and_holds_its_ranges(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("forward"):
            with trace.span("front"):
                torch.ones(4).add_(1)
    assert trace.span("forward") is trace._NULL  # off again after the session
    assert _tree(trace.spans()) == [("forward", None), ("front", 0)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"semstereo:forward", "semstereo:front"} <= names


def _model_runs(device):
    """The tiny model's eval forward and one train step from the seeded
    state, on ``device``: (eval outputs, train scalars, parameters after
    the step, the eval spans, the train spans)."""
    cfg = TrainConfig(model=ModelConfig(**MODEL), compute_dtype="float32")
    state = init_state(cfg, device=device)
    batch = SyntheticStereoDataset(2, S, S, 16).batch(0, 2)
    batch = {k: v.to(device) for k, v in batch.items()}
    model = state.model.eval()
    out = model(batch["left"][:1], batch["right"][:1])
    eval_spans = trace.spans()
    trace.reset()
    scalars = make_train_step(cfg)(state, batch)
    train_spans = trace.spans()
    trace.reset()
    return (out, scalars, {n: p.detach().clone() for n, p in state.model.named_parameters()},
            eval_spans, train_spans)


def _flat(out):
    return [t for v in out.values() for t in (v if isinstance(v, tuple) else (v,))]


def test_the_model_gives_the_same_bits_and_the_span_tree_with_spans_on():
    # PyTorch's own CPU convolutions: oneDNN's round some convs one of
    # several ways from run to run (tests/test_torch_train_model.py)
    with torch.backends.mkldnn.flags(enabled=False):
        off = _model_runs("cpu")
        assert off[3] == [] and off[4] == []
        trace.enable()
        on = _model_runs("cpu")
    got = [_flat(run[0]) + list(run[1].values()) + list(run[2].values()) for run in (off, on)]
    assert len(got[0]) == len(got[1])
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert _tree(on[3]) == EVAL_TREE
    assert _tree(on[4]) == TRAIN_TREE
    assert {s["request"] for s in on[4]} == {0}


@pytest.mark.parametrize("stage1,fuse,names", [
    (True, None, ["forward", "front", "front", "stage1"]),
    (False, True, ["forward", "front", "stage1", "stage2"])])
def test_a_stage1_model_has_no_stage2_span_and_fused_views_one_front(stage1, fuse, names):
    model = build_model(ModelConfig(**MODEL, att_weights_only=stage1), device="cpu",
                        fuse_views=fuse)
    x = torch.rand(1, S, S, 3)
    trace.enable()
    model(x, x)
    assert [s["name"] for s in trace.spans()] == names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device_s comes from CUDA events")
    return torch.device("cuda")


def test_device_time_is_positive_and_within_the_parent_on_the_card(cuda):
    trace.enable()
    _, _, _, eval_spans, train_spans = _model_runs(cuda)
    for spans, tree in ((eval_spans, EVAL_TREE), (train_spans, TRAIN_TREE)):
        assert _tree(spans) == tree
        for s in spans:
            assert s["device_s"] is not None and s["device_s"] > 0, s
            if s["parent"] is not None:
                assert s["device_s"] <= spans[s["parent"]]["device_s"], s
