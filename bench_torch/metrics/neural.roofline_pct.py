"""neural.roofline_pct: the least time the card could take for a neural
frame, over the neural kernel's device time a frame, in percent. The least
time is the largest of the MLP's FLOPs (2 x sum of in x out a pixel, from
the net's widths) at the bf16 tensor peak, the per-pixel fp32 operations
(counts/neural_pixel_ops.json, plus 2 a hidden unit) at the fp32 peak, and
4 bytes a pixel written at the memory peak."""

NEURAL = ("neural_fused_kernel", "neural_render_kernel")


def read(rec):
    ops = [b - a for n, a, b in rec.kernels if any(g in n for g in NEURAL)]
    if not ops or not rec.net or rec.frames <= 0:
        return None
    peaks, px = rec.counts["peaks"], rec.pixels
    mlp = 2 * sum(i * o for i, o in rec.net) * px
    hidden = sum(o for _, o in rec.net[:-1])
    npo = rec.counts["neural_pixel_ops"]
    pix = (npo["counts"][rec.config["renderer"]["model"]] + npo["per_hidden_unit"] * hidden) * px
    least = max(mlp / peaks["bf16_tensor_flops_per_s"], pix / peaks["fp32_flops_per_s"],
                4 * px / peaks["hbm_bytes_per_s"])
    return 100.0 * least / (sum(ops) / rec.frames)
