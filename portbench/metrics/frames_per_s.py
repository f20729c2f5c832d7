"""frames_per_s: frames that went through the cell's entry in the window
(all sequences' in a batched cell), over the window's seconds (host clock,
from the first call's start to the last call's end)."""


def read(rec):
    return rec["frames"] / rec["window_s"]
