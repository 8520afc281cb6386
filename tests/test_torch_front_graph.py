"""The eval front end as one CUDA graph (``models/semstereo.py``:
``SemStereo._fronts``, ``_FrontGraph``).

On the CPU:
* the graph engages only in eval, under ``inference_mode``, on a whole
  model (no ``mesh``, no row split) and on two CUDA views of one shape,
  dtype and device, outside a capture; a CPU forward and a train forward
  count their front end as eager;
* the key changes with the views' shape, dtype and strides, with
  ``fuse_views``, and with every change to the front end's weights that
  ``layers.derived`` sees: a load, an in-place write, new storage, a new
  tensor;
* ``train()`` drops the kept key, ``eval()`` keeps it;
* the counters record nothing while the trace is off.

On the card (skipped without one): under ``cudnn.deterministic`` the
replay gives the eager front end's bits in bf16 and fp32, two-pass and
fused, at two shapes; a request's outputs survive the next request; a
weight load captures again; ``train()`` returns the graph's memory; a
capture and its replays run under the profiler.
"""

import copy

import pytest
import torch

from semstereo_tpu_torch import trace
from semstereo_tpu_torch.config import ModelConfig
from semstereo_tpu_torch.models import build_model
from semstereo_tpu_torch.models.semstereo import _FrontGraph
from semstereo_tpu_torch.nn.layers import split_rows

try:
    from tests._torch_threads import two_torch_threads  # noqa: F401
except ImportError:  # an installed package named ``tests`` shadows this directory
    pass

S = 64
MODEL = dict(maxdisp=16, topk=4, att_window1=(1, 2, 2), att_window2=(1, 2, 2))


@pytest.fixture(autouse=True)
def clean_record():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def model():
    return build_model(ModelConfig(**MODEL), device="cpu")


@pytest.fixture
def own(model):
    """A copy of the module's model that a test may change."""
    return copy.deepcopy(model).eval()


class _Mesh:
    """A stand-in for ``parallel.Mesh``: what ``split_rows`` reads."""
    rows = True


def _unsplit(m):
    m.mesh = None
    split_rows(m, None)


# (what is done to the eval model or the views, whether the graph may engage)
CASES = {
    "eval": (lambda m, l, r: (l, r), True),
    "train": (lambda m, l, r: (m.train(), l, r)[1:], False),
    "mesh": (lambda m, l, r: (setattr(m, "mesh", _Mesh()), l, r)[1:], False),
    "row_split": (lambda m, l, r: (split_rows(m, _Mesh()), l, r)[1:], False),
    "other_shape": (lambda m, l, r: (l, r[:, :S // 2]), False),
    "other_dtype": (lambda m, l, r: (l, r.double()), False),
}


@pytest.mark.parametrize("case", CASES)
def test_the_graph_engages_only_in_whole_eval_on_like_cuda_views(monkeypatch, model, case):
    # CUDA views stood in by CPU tensors that say they are on the card
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    change, want = CASES[case]
    x = torch.rand(1, S, S, 3)
    try:
        left, right = change(model.eval(), x, x.clone())
        with torch.inference_mode():
            assert model._front_graphable(left, right) is want
        assert not model._front_graphable(left, right)  # outside inference_mode
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        with torch.inference_mode():
            assert not model._front_graphable(left, right)
    finally:
        _unsplit(model)
        model.eval()


@pytest.mark.parametrize("fuse", [None, True])
def test_cpu_and_train_forwards_count_their_front_end_as_eager(own, fuse):
    own.fuse_views = fuse
    x = torch.rand(1, S, S, 3)
    trace.enable()
    own(x, x)
    own(x, x)
    assert trace.counts() == {"front_eager": 2}
    own.train()
    own(x, torch.rand(1, S, S, 3))
    assert trace.counts() == {"front_eager": 3}
    assert "_front_graph" not in own.__dict__


def _load(m):
    m.load_state_dict(m.state_dict())


def _write(m):
    with torch.no_grad():
        m.feature_up.deconv4_2.conv2.conv.weight.mul_(1)


def _new_storage(m):
    bn = m.feature.conv_stem.bn
    bn.running_var.data = bn.running_var.data.clone()


def _new_tensor(m):
    conv = m.feature.block0[0].conv1_1x1.conv
    conv.weight = torch.nn.Parameter(conv.weight.detach())  # the same storage and version


def _buffer_write(m):
    m.feature.block4[1].conv_proj.bn.running_mean.add_(0)


@pytest.mark.parametrize("change", [_load, _write, _new_storage, _new_tensor, _buffer_write])
def test_the_key_moves_with_the_front_end_weights(own, change):
    modules = (own.feature, own.feature_up)
    x = torch.rand(1, S, S, 3)
    slot = _FrontGraph(modules, None, x, x)
    assert slot.holds(modules, None, x, x)
    assert slot.holds(modules, None, x.clone(), torch.rand(1, S, S, 3))  # other values
    change(own)
    assert not slot.holds(modules, None, x, x)
    assert _FrontGraph(modules, None, x, x).holds(modules, None, x, x)


@pytest.mark.parametrize("other", [
    lambda x: (True, x, x),  # fused
    lambda x: (None, torch.rand(1, S, 2 * S, 3), torch.rand(1, S, 2 * S, 3)),  # shape
    lambda x: (None, torch.rand(2, S, S, 3), torch.rand(2, S, S, 3)),  # batch
    lambda x: (None, x.double(), x.double()),  # dtype
    lambda x: (None, x.transpose(1, 2), x.transpose(1, 2)),  # strides
])
def test_the_key_moves_with_the_views_and_fusion(model, other):
    modules = (model.feature, model.feature_up)
    x = torch.rand(1, S, S, 3)
    slot = _FrontGraph(modules, None, x, x)
    assert not slot.holds(modules, *other(x))
    assert not slot.holds((model.feature, model.feature), None, x, x)


def test_train_drops_the_kept_key_and_eval_keeps_it(own):
    x = torch.rand(1, S, S, 3)
    own.__dict__["_front_graph"] = slot = _FrontGraph((own.feature, own.feature_up), None, x, x)
    own.eval()
    assert own.__dict__["_front_graph"] is slot
    own.train()
    assert "_front_graph" not in own.__dict__


def test_the_counters_record_nothing_while_the_trace_is_off(model):
    x = torch.rand(1, S, S, 3)
    model(x, x)
    trace.count("front_replay")
    assert trace.counts() == {}
    trace.enable()
    trace.count("front_replay")
    assert trace.counts() == {"front_replay": 1}
    trace.reset()
    assert trace.counts() == {}


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only there")
    return torch.device("cuda")


def _pair(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(1, *shape, 3, generator=g).to("cuda", dtype) for _ in range(2)]


def _cuda_model(dtype, fuse=None):
    return build_model(ModelConfig(**MODEL), device="cuda", dtype=dtype, seed=3, fuse_views=fuse)


def _equal(a, b):
    fa = [t for v in a.values() for t in (v if isinstance(v, tuple) else (v,))]
    fb = [t for v in b.values() for t in (v if isinstance(v, tuple) else (v,))]
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


def _fronts(m, left, right):
    with torch.inference_mode():
        feats, fl, fr = m._fronts(left, right, bool(m.fuse_views))
        return [t.clone() for t in fl + fr]


@pytest.mark.parametrize("fuse", [None, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replay_gives_the_eager_front_end_bit_for_bit(cuda, dtype, fuse):
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        for shape in ((S, S), (2 * S, S)):
            m = _cuda_model(dtype, fuse)
            left, right = _pair(shape, dtype, seed=shape[0])
            trace.enable()
            fronts = [_fronts(m, left, right) for _ in range(3)]
            assert trace.counts() == {"front_eager": 1, "front_capture": 1, "front_replay": 1}
            trace.disable()
            trace.reset()
            for got in fronts[1:]:
                assert all(torch.equal(a, b) for a, b in zip(got, fronts[0]))
            replayed = m(left, right)
            eager = _cuda_model(dtype, fuse)(left, right)  # a key's first forward
            assert _equal(replayed, eager)


def test_a_request_keeps_its_outputs_through_the_next(cuda):
    m = _cuda_model(torch.bfloat16)
    pairs = [_pair((S, S), torch.bfloat16, seed) for seed in range(4)]
    for left, right in pairs[:2]:  # eager, then capture
        m(left, right)
    a = m(*pairs[2])
    kept = {k: tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
            for k, v in a.items()}
    b = m(*pairs[3])
    torch.cuda.synchronize()
    assert _equal(a, kept) and not _equal(a, b)


def test_a_weight_load_captures_again(cuda):
    dtype = torch.float32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        m = _cuda_model(dtype)
        left, right = _pair((S, S), dtype, seed=7)
        for _ in range(3):
            m(left, right)
        other = build_model(ModelConfig(**MODEL), device="cuda", dtype=dtype, seed=4)
        want = other(left, right)
        trace.enable()
        m.load_state_dict(other.state_dict())
        got = [m(left, right) for _ in range(3)]
        assert trace.counts() == {"front_eager": 1, "front_capture": 1, "front_replay": 1}
        assert all(_equal(g, want) for g in got)


def test_train_returns_the_graph_memory(cuda):
    m = _cuda_model(torch.bfloat16)
    left, right = _pair((4 * S, 4 * S), torch.bfloat16, seed=9)
    for _ in range(2):  # eager, then capture
        m(left, right)
    pool = tuple(m.__dict__["_front_graph"].graph.pool())

    def pool_bytes():
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)

    held, reserved = pool_bytes(), torch.cuda.memory_reserved()
    assert held > 0
    m.train()
    assert "_front_graph" not in m.__dict__
    assert pool_bytes() == 0 and torch.cuda.memory_reserved() <= reserved - held


def test_a_capture_and_its_replays_under_the_profiler(cuda):
    from torch.profiler import ProfilerActivity, profile

    m = _cuda_model(torch.bfloat16)
    left, right = _pair((S, S), torch.bfloat16, seed=11)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            outs = [m(left, right) for _ in range(4)]
            torch.cuda.synchronize()
    assert trace.counts() == {"front_eager": 1, "front_capture": 1, "front_replay": 2}
    assert all(_equal(o, outs[0]) for o in outs[1:])
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels
