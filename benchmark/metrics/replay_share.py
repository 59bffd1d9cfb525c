"""`replay_share` (%): the traced run's `processor.replay` spans over its
`processor.call` spans, x 100 (`export/streaming.py`): the share of the
profiled calls that ran as one replay of the captured CUDA graph.  None
where the program has no such spans."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary()
    calls, replays = found.get("processor.call"), found.get("processor.replay")
    if calls is None or replays is None:
        return None
    return 100.0 * replays["count"] / calls["count"]
