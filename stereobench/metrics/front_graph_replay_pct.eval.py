"""Share of the eval forwards in the traced window whose front end
(``SemStereo._front``: the backbone and ``feature_up`` of both views) was
a replay of its CUDA graph, in %: the program's counter ``front_replay``
over ``front_replay``, ``front_capture`` and ``front_eager``.  None where
the program keeps no such counters, and in train cells."""

COUNTERS, REPLAY, MODE = ("front_replay", "front_capture", "front_eager"), "front_replay", "eval"


def read(s: dict):
    if s.get("mode") != MODE:
        return None
    try:
        from semstereo_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    counts = getattr(trace, "counts", None)
    if counts is None:  # a program without counters
        return None
    c = counts()
    total = sum(c.get(k, 0) for k in COUNTERS)
    return 100.0 * c.get(REPLAY, 0) / total if total else None
