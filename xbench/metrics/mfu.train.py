"""The whole training step's share of the chip's bf16 peak (percent): the
model FLOPs of the steps completed in the window (6 x active parameters
less the input embedding x tokens, plus causal attention) over the
window's seconds, over 989 TFLOP/s."""

from lib import peaks


def read(rec):
    c = rec["counts"]
    if not c.get("steps"):
        return None
    return 100.0 * c["steps"] * rec["shape"]["flops_per_step"] / c["window_s"] \
        / peaks.PEAK_BF16_FLOPS
