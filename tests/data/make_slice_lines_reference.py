"""Write tests/data/slice_lines_reference.npz: the reference's point+line
FrameBuilder -> Tracker.step slice, for tests/test_torch_slice_lines.py.

`make_slice_reference.record` on configs/TUM3.yaml (lines on, device LSD)
scaled to 320x240, over the port's frames (`_sequence()`): every frame's
StepOut; frame MID's FrameData whole and the others' line fields (bf16
fields as float32); the TrackState before frame MID; and the step on frame
MID from it ("step.shared").

    python tests/data/make_slice_lines_reference.py [OUT]   # ~60 s on 8 CPU cores
"""

import sys

import make_slice_reference as ms  # first: it puts the repo and tests/ on the path and sets up JAX
import test_torch_slice_lines as t


def main(out=ms.rr.path("slice_lines")):
    others = [i for i in range(t.N_FRAMES) if i != t.MID]
    ms.record(t, out, {"shared": lambda d: d}, full_frames=(t.MID,), line_frames=others, final_state=False)


if __name__ == "__main__":
    main(*sys.argv[1:])
