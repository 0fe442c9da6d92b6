"""How far the neural frames move if every hidden tanh carried a relative
error, modelled on the CPU with the plain version.

    python3 -m bhr_tpu_torch.tools.tanh_sensitivity [BITS ...]

For each BITS (default 11, 16, 20) and each committed default net (N1 on
the default camera, N2 at spin 0.9 from [15,5,0]), renders a 480x270 frame
with neural_render_packed_reference twice: as it is, and with torch.tanh
replaced by tanh(x) (1 + u 2^-BITS), u uniform in [-1, 1) from a seeded
generator -- a model of an approximate tanh such as tanh.approx.f32, whose
relative error is at most about 2^-11 -- and prints one JSON line with the
share of pixels bit-equal, off by more than 2 levels, and with the same
black (capture) mask: the numbers bhr_tpu's bars hold (>= 0.99, <= 0.001,
>= 0.999). A model of the error's size, not of the instruction's bits.
"""

from __future__ import annotations

import json
import sys

import torch

W, H = 480, 270
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
CASES = (("n1", "schwarzschild", "neural_schwarzschild.npz", 0.0, False),
         ("n2", "kerr", "neural_kerr.npz", 0.9, True))


def frame_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """bit_same, off_by_more_than_2 and black_agree of two packed frames."""
    k = got.view(torch.uint8).view(*got.shape, 4)[..., :3].int()
    p = want.view(torch.uint8).view(*want.shape, 4)[..., :3].int()
    return {"bit_same": (got == want).float().mean().item(),
            "off_by_more_than_2": ((k - p).abs().amax(-1) > 2).float().mean().item(),
            "black_agree": ((k == 0).all(-1) == (p == 0).all(-1)).float().mean().item()}


def main(argv=None) -> None:
    import bhr_tpu_torch as bt
    from bhr_tpu_torch.models import neural as tn
    from bhr_tpu_torch.models import neural_kerr as tnk
    from bhr_tpu_torch.ops import neural_kernel as nk

    bits = [int(b) for b in (argv if argv is not None else sys.argv[1:])] or [11, 16, 20]
    exact = torch.tanh
    for name, model, asset, spin, side in CASES:
        params = (tnk if model == "kerr" else tn).load_params(tn.ASSETS_DIR / asset)[0]
        cam = bt.Camera.new(*SIDE) if side else bt.Camera.default()
        scene = bt.SceneParams(screen_width=W, screen_height=H, spin=spin)
        want = nk.neural_render_packed_reference(params, cam, scene, device="cpu")
        for b in bits:
            gen = torch.Generator().manual_seed(1)

            def approx(x, b=b, gen=gen):
                y = exact(x)
                return y * (1 + (torch.rand(y.shape, generator=gen) * 2 - 1) * 2.0 ** -b)

            torch.tanh = approx
            try:
                got = nk.neural_render_packed_reference(params, cam, scene, device="cpu")
            finally:
                torch.tanh = exact
            print(json.dumps({"case": name, "bits": b, **frame_stats(got, want)}), flush=True)


if __name__ == "__main__":
    main()
