"""factor_tflops: (1/3)·N³ for each factorization completed in the window,
over the window's seconds, in TFLOP/s (the reference's accounting,
``v6_test.c:60``). The window holds whole factorizations and their
restages."""

from portbench import roofline


def read(run):
    w = run.window
    return w["count"] * roofline.potrf_flops(run.config["n"]) / w["window_s"] / 1e12
