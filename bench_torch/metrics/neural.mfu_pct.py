"""neural.mfu_pct: the whole neural frame's share of the card's bf16 tensor
peak: the MLP's FLOPs a frame (2 x sum of in x out a pixel, from the net's
widths) over the traced window's mean frame interval times the peak, in
percent."""


def read(rec):
    if not rec.net or rec.frame_interval_ms <= 0:
        return None
    mlp = 2 * sum(i * o for i, o in rec.net) * rec.pixels
    peak = rec.counts["peaks"]["bf16_tensor_flops_per_s"]
    return 100.0 * mlp / (rec.frame_interval_ms * 1e-3 * peak)
