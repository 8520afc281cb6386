"""The program's hard choices of disparity planes, taken where its forward
makes them: the top-k planes of the /8 attention
(``models.semstereo.topk_plane_indices``) and the refine top-k of the /4
cost (inside ``models.semstereo.regression_topk``).  The plain reference
follows them (``reference/model.py``) and reports how far each is from its
own choice, since an untrained net's choice among near-ties turns on
rounding.  Installed only outside the measured window: on the three
checked train steps of set-up, and on the re-run of the sampled eval
requests after the window."""

from __future__ import annotations

import functools


class Choices:
    def __init__(self):
        self.taken: list[dict] = []  # one dict per forward: 'topk', 'refine' on the host
        self._undo: list = []

    def install(self) -> None:
        import semstereo_tpu_torch.models.semstereo as sm
        from semstereo_tpu_torch.ops.regression import _topk_indices

        def topk(orig):
            @functools.wraps(orig)
            def f(weights, k):
                ind = orig(weights, k)
                self.taken.append({"topk": ind.detach().cpu()})
                return ind
            return f

        def refine(orig):
            @functools.wraps(orig)
            def f(cost, samples, k):
                self.taken[-1]["refine"] = _topk_indices(cost.detach().movedim(1, -1), k).cpu()
                return orig(cost, samples, k)
            return f

        for attr, make in (("topk_plane_indices", topk), ("regression_topk", refine)):
            orig = getattr(sm, attr)
            setattr(sm, attr, make(orig))
            self._undo.append(lambda attr=attr, orig=orig: setattr(sm, attr, orig))

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def batch_of(taken: dict, j: int | None, device) -> dict:
    """The choices of row ``j`` (all rows for None) on ``device``."""
    sl = slice(None) if j is None else slice(j, j + 1)
    return {k: v[sl].to(device) for k, v in taken.items()}
