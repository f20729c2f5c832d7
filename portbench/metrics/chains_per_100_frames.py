"""chains_per_100_frames: keyframe-chain dispatches per 100 frames of the
traced window (a count)."""


def read(rec):
    if "spans" not in rec or not rec["frames"]:
        return None
    return 100.0 * len(rec["spans"].get("chain", [])) / rec["frames"]
