"""launches_per_frame: kernels the card ran in the profiled sub-window
(copies and sets left out), per frame of the sub-window."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["frames"] or not p["launches"]:
        return None
    return p["launches"] / p["frames"]
