"""The live index (``index/live.py`` ``LiveIndex.merge_delta``): host ms
a merge took, the window's summed ``merge_ms`` of the mutation stream's
records over its merges and forced merges (host clock around each
``merge_delta``, which ends in host reads of the new layout).  Nothing
from a window without the stream's records or without a merge, nor from
a run whose trace holds no device operation: on the CPU a merge moves
no device memory."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    recs = [c.mutations for c in run.window.calls]
    if any(r is None for r in recs):
        return None
    merges = sum(r["merges"] + r["forced_merges"] for r in recs)
    if not merges:
        return None
    return sum(r["merge_ms"] for r in recs) / merges
