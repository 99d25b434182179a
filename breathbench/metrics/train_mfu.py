"""The whole step's share of the card's bf16 peak, %: the yardstick's
FLOPs of one step (breathbench/flops.py: convolutions, mm, bmm and FFTs
counted on the plain reference and the configuration's frozen feature
count, no elementwise work) times the steps in the traced window, over the
traced window's seconds, over 989 TFLOP/s (H100 SXM, dense bf16, 700 W;
the card's power limit is in the result's device.card)."""
from breathbench import harness


def read(run):
    t, c = run.trace_data, run.counters
    if t is None or t.window_s <= 0 or not c.get("traced_steps") \
            or not c.get("flops_per_step"):
        return None
    flops = c["flops_per_step"] * c["traced_steps"]
    return 100.0 * flops / t.window_s / harness.PEAK_BF16_FLOPS
