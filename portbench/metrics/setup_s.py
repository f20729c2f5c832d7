"""setup_s: process start to the first timed call: imports, the kernel
build (cached in the checkout after the first run), rendering the frames,
the warm-up session and whatever else the cell's set-up does."""


def read(rec):
    return rec["setup_s"]
