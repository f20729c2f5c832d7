"""dispatch_ms_per_frame: host milliseconds inside the `dispatch` spans
(System._dispatch_chunk; in the batched entry the FrameBuilder calls and
BatchedTracker.step) per frame of the traced window."""


def read(rec):
    spans = rec.get("spans", {}).get("dispatch", [])
    if not spans or not rec["frames"]:
        return None
    return sum(e - s for s, e in spans) / 1e6 / rec["frames"]
