"""The probe kernels' plain versions (bhr_tpu_torch/tools/hopper_probe.py)
against bhr_tpu's probe scripts, whose Pallas kernels run here in interpret
mode (the scripts are imported as modules; nothing in scripts/ changes).

* ieee_probe.py: XLA's CPU lowering contracts the Markstein and
  rsqrt-refinement expressions into FMAs. Fed the interpret-mode estimate
  (k_recip_approx, k_rsqrt), the port's sequences in the FMA form (an
  exact single-rounding emulation of __fmaf_rn) equal k_mark and
  k_sqrt_seq bit for bit on >= 99.99% of 256 x 1024 samples, at most 2 ulp
  off elsewhere; on these samples every case is bit-equal. The uncontracted
  form (the exact tier's rule) is held within 2 ulp: it differs on up to a
  quarter of the quotients.
* The gathers are exact against the interpret-mode outputs of
  gather_probe2.py and pallas_gather_bench.py on their own shapes. The
  probes' roll butterflies (gather_probe2.py:roll_pos,
  lut_butterfly_probe.py:butterfly_*) are not gathers in interpret mode
  (their own check prints agreement 0.01-0.04), so the port's shuffle
  variant is held to what those probes compare against, tbl[idx], on their
  inputs.
* The dots: bf16 and fp32 plain versions within 1e-6 relative of
  neural_precision_probe.kernel_for(None / HIGHEST) in interpret mode, the
  bf16 one on bf16-rounded operands (the CPU honours no precision argument).
* neural_kernel_probe.py's kernels, captured from the script and run in
  interpret mode on random inputs of the script's shapes: the sublane
  concatenations (16, 22, 24 and 32 rows) bit-equal to probe_concat's
  plain version; the bf16 chain's tanh of a bf16-rounded sum bit-equal to
  probe_dot's with round_bf16, and its output within 1e-6 relative; the
  fp32 and bf16 dots within 1e-6 relative.

The kernels themselves run only on a CUDA device: those tests are marked
`gpu` and skip elsewhere.
"""

import functools
import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bhr_tpu_torch.tools import hopper_probe as hp
from bhr_tpu_torch.utils import tracing

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
ROWS = 256  # ieee_probe.py:ROWS_PER_BLOCK, one block of 256 x 1024 samples


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_block(body, inputs):
    """ieee_probe.run_kernel in interpret mode."""
    shape = inputs[0].shape
    spec = pl.BlockSpec((ROWS, shape[1]), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), in_specs=[spec for _ in inputs],
        out_specs=spec, grid=(shape[0] // ROWS,), interpret=True)(*inputs))


@pytest.fixture(scope="module")
def ieee():
    ip = _script("ieee_probe")
    rng = np.random.default_rng(7)
    n = ROWS * 1024
    a = ip.rand_fp32(rng, n).reshape(ROWS, 1024)
    b = ip.rand_fp32(rng, n).reshape(ROWS, 1024)
    np.testing.assert_array_equal(a.reshape(-1), hp.rand_fp32(np.random.default_rng(7), n))
    da, db = jnp.asarray(a), jnp.asarray(b)
    dabs = jnp.abs(da)
    return dict(ip=ip, a=a, b=b, da=da, db=db, dabs=dabs,
                rcp=_interpret_block(ip.k_recip_approx, [db]),
                rsqrt=_interpret_block(ip.k_rsqrt, [dabs]))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("fixup", [False, True], ids=["f0", "f1"])
@pytest.mark.parametrize("n_refine", [1, 2], ids=["r1", "r2"])
def test_markstein_matches_ieee_probe_interpret(ieee, n_refine, fixup):
    ip = ieee["ip"]
    want = _interpret_block(functools.partial(ip.k_mark, n_refine, fixup), [ieee["da"], ieee["db"]])
    args = (_t(ieee["a"]), _t(ieee["b"]))
    fma = hp.ieee_reference("markstein", *args, y0=_t(ieee["rcp"]), n_refine=n_refine,
                            fixup=fixup, fma=True).numpy()
    ud = hp.ulp_diff(fma, want)
    assert (ud == 0).mean() >= 0.9999 and ud.max() <= 2, ((ud == 0).mean(), ud.max())
    unc = hp.ieee_reference("markstein", *args, y0=_t(ieee["rcp"]), n_refine=n_refine,
                            fixup=fixup, fma=False).numpy()
    assert hp.ulp_diff(unc, want).max() <= 2


@pytest.mark.parametrize("fixup", [False, True], ids=["f0", "f1"])
@pytest.mark.parametrize("n_refine", [0, 1, 2], ids=["r0", "r1", "r2"])
def test_sqrt_via_rsqrt_matches_ieee_probe_interpret(ieee, n_refine, fixup):
    ip = ieee["ip"]
    want = _interpret_block(functools.partial(ip.k_sqrt_seq, n_refine, fixup), [ieee["dabs"]])
    absa = _t(np.abs(ieee["a"]))
    fma = hp.ieee_reference("sqrt_seq", absa, y0=_t(ieee["rsqrt"]), n_refine=n_refine,
                            fixup=fixup, fma=True).numpy()
    ud = hp.ulp_diff(fma, want)
    assert (ud == 0).mean() >= 0.9999 and ud.max() <= 2, ((ud == 0).mean(), ud.max())
    unc = hp.ieee_reference("sqrt_seq", absa, y0=_t(ieee["rsqrt"]), n_refine=n_refine,
                            fixup=fixup, fma=False).numpy()
    assert hp.ulp_diff(unc, want).max() <= 2


def test_correctly_rounded_ops_match_ieee_probe_interpret(ieee):
    """k_div and k_sqrt (XLA's CPU divide and sqrt, correctly rounded) are
    the plain version's a / b and sqrt, bit for bit; the port's wrapper on
    CPU tensors is its plain version."""
    ip = ieee["ip"]
    a, b, absa = _t(ieee["a"]), _t(ieee["b"]), _t(np.abs(ieee["a"]))
    want_div = _interpret_block(ip.k_div, [ieee["da"], ieee["db"]])
    want_sqrt = _interpret_block(ip.k_sqrt, [ieee["dabs"]])
    for op in ("div", "fdiv_rn"):
        np.testing.assert_array_equal(hp.ieee(op, a, b).numpy(), want_div)
    for op in ("fsqrt_rn", "sqrtf"):
        np.testing.assert_array_equal(hp.ieee(op, absa).numpy(), want_sqrt)
    rs = hp.ieee("frsqrt_rn", absa).numpy()
    np.testing.assert_array_equal(rs, (1.0 / np.sqrt(np.abs(ieee["a"]).astype(np.float64)))
                                  .astype(np.float32))


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, on random operands and on
    products that land near a tie of the float32 sum."""
    rng = np.random.default_rng(11)
    n = 3000
    a = hp.rand_fp32(rng, n, 1e-3, 1e3)
    b = hp.rand_fp32(rng, n, 1e-3, 1e3)
    c = hp.rand_fp32(rng, n, 1e-3, 1e3)
    c[: n // 2] = (-(a[: n // 2].astype(np.float64) * b[: n // 2])).astype(np.float32)
    got = hp.fma32(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        want = ties[0] if len(ties) == 1 else next(v for v in ties
                                                   if np.float32(v).view(np.int32) % 2 == 0)
        assert np.float32(g).view(np.int32) == np.float32(want).view(np.int32), (x, y, z)


# ---- the gathers ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded():
    """Every exact-gather kernel of the three gather probes, run in interpret
    mode: {variant: (inputs, output)}; and the butterflies' inputs."""
    out = {}
    for name in ("gather_probe2", "pallas_gather_bench", "lut_butterfly_probe"):
        mod = _script(name)
        calls, current = [], [None]

        def run_kernel(kernel, out_shape, inputs, **kw):
            res = pl.pallas_call(kernel, out_shape=out_shape, interpret=True, **kw)(*inputs)
            calls.append((current[0], [np.asarray(x) for x in inputs], np.asarray(res)))
            return res

        def check(variant, fn):
            if "timing" in variant:
                return  # a 1080p timing kernel: the card's numbers come from hopper_probe
            current[0] = variant
            try:
                fn()
            except ValueError:  # pallas_gather_bench.py:roll's negative shift, as its own check
                pass

        mod.run_kernel, mod.check = run_kernel, check
        mod.main()
        for variant, inputs, res in calls:
            out[f"{name}:{variant}"] = (inputs, res)
    return out


def _flat_indices(kind, tbl, idx):
    """The flat table index of each lookup of a probe variant."""
    if kind == "rows":  # take_along_axis(tbl, idx, axis=0)
        return idx * tbl.shape[1] + np.arange(tbl.shape[1])[None, :]
    if kind == "lanes":  # take_along_axis(tbl, idx, axis=1)
        return np.arange(tbl.shape[0])[:, None] * tbl.shape[1] + idx
    return idx  # take over the flattened table


EXACT_GATHERS = {
    "gather_probe2:tal0_8": "rows", "gather_probe2:tal0_512": "rows",
    "gather_probe2:tal0_2048": "rows", "gather_probe2:take2d": "flat",
    "pallas_gather_bench:tal0": "rows", "pallas_gather_bench:tal0_u32": "rows",
    "pallas_gather_bench:tal1": "lanes", "pallas_gather_bench:take1d": "flat",
}


@pytest.mark.parametrize("variant", sorted(EXACT_GATHERS))
def test_gathers_match_the_probes_interpret_outputs(recorded, variant):
    (tbl, idx), want = recorded[variant]
    flat = _flat_indices(EXACT_GATHERS[variant], tbl, idx).astype(np.int32)
    table = torch.from_numpy(tbl.view(np.int32).reshape(-1).copy())
    srcs = [s for s in hp.GATHER_SRCS if table.numel() <= hp.GATHER_CAPACITY[s]]
    assert "ldg" in srcs
    for src in srcs:
        got = hp.gather(src, table, torch.from_numpy(flat)).numpy()
        np.testing.assert_array_equal(got, want.view(np.int32), err_msg=src)


@pytest.mark.parametrize("variant", ["gather_probe2:roll_pos", "lut_butterfly_probe:butterfly_512",
                                     "lut_butterfly_probe:butterfly_640",
                                     "lut_butterfly_probe:butterfly_left_512"])
def test_shuffle_gather_on_the_butterfly_probes_inputs(recorded, variant):
    (x, idx), _ = recorded[variant]
    kind = "lanes" if variant.startswith("gather_probe2") else "row"
    if kind == "row":  # a (1, W) LUT row, (8, W) indices: want = lut[0][idx]
        flat, table = idx, x.reshape(-1)
    else:  # (8, 128) rows, lane targets: want = take_along_axis(x, tgt, axis=1)
        flat, table = _flat_indices("lanes", x, idx), x.reshape(-1)
    want = table.view(np.int32)[flat]
    tt = torch.from_numpy(table.view(np.int32).copy())
    if tt.numel() <= hp.GATHER_CAPACITY["shfl"]:
        got = hp.gather("shfl", tt, torch.from_numpy(flat.astype(np.int32))).numpy()
        np.testing.assert_array_equal(got, want)
    got = hp.gather("ldg", tt, torch.from_numpy(flat.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


def test_pattern_indices_are_the_bench_hash():
    """pallas_gather_bench.py:tal0_timing's index: (row 1619 + col 31337 +
    seed) & 0x7fffffff mod 2048 on the rows of a (2048, 128) table, the
    column mod 128, in wrapping int32 arithmetic."""
    h, w, seed = 16, 256, 7919 * 3 + 4
    j = hp.pattern_indices((h, w), (2048, 128), "hashed", seed).numpy()
    rows = np.arange(h, dtype=np.int32)[:, None]
    cols = np.arange(w, dtype=np.int32)[None, :]
    hsh = (rows * np.int32(1619) + cols * np.int32(31337) + np.int32(seed)) & 0x7FFFFFFF
    np.testing.assert_array_equal(j, (hsh % 2048) * 128 + cols % 128)
    coh = hp.pattern_indices((h, w), (512, 1), "coherent").numpy()
    assert coh.min() == 0 and coh.max() < 512 and (np.diff(coh, axis=1) >= 0).all()
    tex = hp.pattern_indices((h, w), (64, 128), "coherent").numpy()
    np.testing.assert_array_equal(tex[3, 5], (3 * 64 // h) * 128 + 5 * 128 // w)


def test_gather_shuffle_rounds_equal_a_lookup():
    rng = np.random.default_rng(2)
    for n in (8, 33, 512, 640):
        table = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32))
        for pattern in ("hashed", "coherent"):
            got = hp.gather_reference("shfl", table, shape=(8, 96), pattern=pattern, seed=5)
            want = hp.gather_reference("ldg", table, shape=(8, 96), pattern=pattern, seed=5)
            assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = torch.zeros(1 << 15, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        hp.gather("const", t, shape=(8, 8))
    with pytest.raises(ValueError, match="not both"):
        hp.gather("ldg", t, torch.zeros(4, dtype=torch.int32), shape=(2, 2))
    with pytest.raises(ValueError, match="unknown gather source"):
        hp.gather("texture", t, shape=(2, 2))
    with pytest.raises(ValueError, match="cannot multiply"):
        hp.dot(torch.zeros(4, 3), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="unknown probe_dot precision"):
        hp.dot(torch.zeros(4, 3), torch.zeros(3, 5), prec="tf32")
    with pytest.raises(ValueError, match="takes a and b"):
        hp.ieee("div", torch.ones(4))
    with pytest.raises(ValueError, match="unknown probe_ieee op"):
        hp.ieee("exp", torch.ones(4))
    with pytest.raises(ValueError, match="must be \\(8, P\\)"):
        hp.concat(torch.zeros(7, 16), 16)
    with pytest.raises(ValueError, match="takes a CUDA table"):
        hp.upload_const(torch.zeros(8, dtype=torch.int32))


# ---- the dots -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def precision_probe():
    npp = _script("neural_precision_probe")
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((128, 256)) * (1 + 1e-4)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    return npp, a, b


def _interpret_dot(npp, precision, a, b):
    return np.asarray(pl.pallas_call(npp.kernel_for(precision),
                                     out_shape=jax.ShapeDtypeStruct((128, 256), jnp.float32),
                                     interpret=True)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("prec", ["bf16", "fp32"])
def test_dots_match_neural_precision_probe_interpret(precision_probe, prec):
    npp, a, b = precision_probe
    if prec == "bf16":  # the CPU's default-precision dot on bf16-rounded operands
        a = np.asarray(torch.from_numpy(a).bfloat16().float())
        b = np.asarray(torch.from_numpy(b).bfloat16().float())
        want = _interpret_dot(npp, None, a, b)
    else:
        want = _interpret_dot(npp, jax.lax.Precision.HIGHEST, a, b)
    got = hp.dot(torch.from_numpy(a), torch.from_numpy(b), prec=prec).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_dot_tiers_against_float64(precision_probe):
    """The bars of the card's check, on the CPU's plain versions: bf16
    within 1e-2 of max |C|, bf16x3 and fp32 within 1e-5, and bf16x3 beats
    bf16 by 50x (high_honored); a zero-padded K changes nothing."""
    _, a, b = precision_probe
    ref = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for prec in hp.DOT_PRECS:
        got = hp.dot(torch.from_numpy(a), torch.from_numpy(b), prec=prec).numpy()
        errs[prec] = np.abs(got - ref).max() / np.abs(ref).max()
        assert errs[prec] <= hp.DOT_MAX_ERR[prec], (prec, errs[prec])
    assert errs["bf16x3"] < errs["bf16"] / 50
    f = torch.from_numpy(a[:32, :22].copy())
    w = torch.from_numpy(b[:22, :64].copy())
    fp = torch.zeros(32, 32)
    fp[:, :22] = f
    wp = torch.zeros(32, 64)
    wp[:22] = w
    assert torch.equal(hp.dot(f, w, prec="bf16"), hp.dot(fp, wp, prec="bf16"))
    bias = torch.linspace(-1, 1, 64)
    torch.testing.assert_close(hp.dot(f, w, bias, prec="fp32", tanh=True),
                               torch.tanh(f.double() @ w.double() + bias.double()).float(),
                               rtol=0, atol=1e-6)


# ---- neural_kernel_probe.py: the concatenations, the bf16 chain, the dots ------------


@pytest.fixture(scope="module")
def kernel_probe():
    """neural_kernel_probe.py's kernels and out_shapes, by probe, captured by
    running its probe functions with pallas_call and run replaced; nothing
    is compiled or run by the capture."""
    mod = _script("neural_kernel_probe")
    captured, current = {}, [None]

    class Capture:
        @staticmethod
        def pallas_call(kernel, out_shape, **kw):
            return lambda *args: (kernel, out_shape, args)

    def run(name, fn, *args):
        captured[current[0]] = fn(*args)
        return True

    mod.pl, mod.run = Capture, run
    for name, fn in (("k16_dot", mod.probe_k16_dot), ("sublane_concat", mod.probe_sublane_concat),
                     ("hidden_chain", mod.probe_hidden_chain), ("head", mod.probe_head),
                     ("bf16_chain", mod.probe_bf16_chain),
                     *((f"kerr_dot_{k}", functools.partial(mod.probe_kerr_dot, k))
                       for k in (22, 24, 32)),
                     *((f"kerr_concat_{n}", functools.partial(mod.probe_kerr_concat, n))
                       for n in (22, 24, 32))):
        current[0] = name
        fn()
    return captured


def _interpret_kernel_probe(captured, inputs):
    kernel, out_shape, args = captured
    assert [(a.shape, a.dtype) for a in args] == [(a.shape, a.dtype) for a in inputs]
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(*inputs)
                      .astype(jnp.float32))


def _like(rng, arr, scale=1.0):
    return jnp.asarray((rng.standard_normal(arr.shape) * scale).astype(np.float32)).astype(arr.dtype)


@pytest.mark.parametrize("probe", ["sublane_concat", "kerr_concat_22", "kerr_concat_24",
                                   "kerr_concat_32"])
def test_concats_match_neural_kernel_probe_interpret(kernel_probe, probe):
    (plane_like,) = kernel_probe[probe][2]
    plane = _like(np.random.default_rng(4), plane_like, 3.0)
    want = _interpret_kernel_probe(kernel_probe[probe], [plane])
    n_rows = want.shape[0]
    period = 8 if probe == "sublane_concat" else None
    bf16 = kernel_probe[probe][1].dtype == jnp.bfloat16
    got = hp.concat(torch.from_numpy(np.array(plane)), n_rows, period, bf16=bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_chain_matches_neural_kernel_probe_interpret(kernel_probe):
    """probe_bf16_chain: w2 = I gives the kernel's tanh(bf16(w1 f)) in bf16,
    bit-equal to probe_dot's round_bf16 layer; with a random w2 the chain's
    output within 1e-6 relative. Without the rounding the port's chain is
    1e-3 off: the flag is the probe's arithmetic."""
    w1_like, w2_like, f_like = kernel_probe["bf16_chain"][2]
    rng = np.random.default_rng(6)
    w1, f = _like(rng, w1_like, 0.25), _like(rng, f_like)
    eye = jnp.eye(w2_like.shape[0], dtype=w2_like.dtype)
    h_want = _interpret_kernel_probe(kernel_probe["bf16_chain"], [w1, eye, f])
    ft, w1t = (torch.from_numpy(np.asarray(x.astype(jnp.float32)).T.copy()) for x in (f, w1))
    h = hp.dot(ft, w1t, prec="bf16", tanh=True, round_bf16=True)
    np.testing.assert_array_equal(h.numpy().T, h_want)
    w2 = _like(rng, w2_like, 0.1)
    want = _interpret_kernel_probe(kernel_probe["bf16_chain"], [w1, w2, f])
    w2t = torch.from_numpy(np.asarray(w2.astype(jnp.float32)).T.copy())
    got = hp.dot(h, w2t, prec="bf16").numpy().T
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    unrounded = hp.dot(hp.dot(ft, w1t, prec="bf16", tanh=True), w2t, prec="bf16").numpy().T
    assert np.abs(unrounded - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("probe", ["k16_dot", "hidden_chain", "head", "kerr_dot_22", "kerr_dot_24",
                                   "kerr_dot_32"])
def test_dots_match_neural_kernel_probe_interpret(kernel_probe, probe):
    """The probe's (out, K) @ (K, P) products as probe_dot's (P, K) @ (K, out)
    plain versions: fp32 operands at the fp32 tier, bf16 ones at the bf16
    tier; the hidden chain's two layers with their tanh."""
    rng = np.random.default_rng(8)
    inputs = [_like(rng, a, 0.25) for a in kernel_probe[probe][2]]
    want = _interpret_kernel_probe(kernel_probe[probe], inputs)
    prec = "bf16" if inputs[0].dtype == jnp.bfloat16 else "fp32"
    tt = [torch.from_numpy(np.asarray(x.astype(jnp.float32)).T.copy()) for x in inputs]
    if probe == "hidden_chain":
        w1t, w2t, ft = tt
        got = hp.dot(hp.dot(ft, w1t, prec=prec, tanh=True), w2t, prec=prec, tanh=True)
    else:
        wt, ft = tt
        got = hp.dot(ft, wt, prec=prec)
    assert np.abs(got.numpy().T - want).max() <= 1e-6 * np.abs(want).max()


def test_hopper_probe_runs_on_the_cpu():
    """The entry point at tiny sizes on the CPU: every check passes (plain
    versions against themselves and numpy), nothing is timed, nothing is
    launched, and each kernel variant has a record."""
    lines = []
    def launches():
        return sum(n for k, n in tracing.COUNTS.items() if k.startswith("launch.probe_"))

    before = launches()
    run = hp.run_probes("cpu", small=True, emit=lines.append)
    assert run.failed == [] and len(run.checks) > 60
    assert {a["answer"] for a in run.answers} >= {"ieee_correctly_rounded", "ieee_estimates",
                                                  "ieee_sequences", "dot_precision", "dot_shapes"}
    assert launches() == before
    assert set(run.kernels) == ({f"probe_ieee<{op}>" for op in hp.IEEE_OPS}
                                | {f"probe_dot<{p}>" for p in hp.DOT_PRECS}
                                | {"probe_concat<fp32>", "probe_concat<bf16>"})
    assert {c["check"] for c in run.checks} >= {"bf16_chain_layer1_bf16", "bf16_chain_bf16",
                                                "concat_16x64_fp32", "concat_22x64_bf16"}
    assert all(r["ms"] is None for r in run.kernels.values())
    assert hp.main(["--device", "cpu", "--small"]) == 0


# ---- on the card ------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels have no CPU mode")


@pytest.mark.gpu
def test_probe_kernels_match_their_plain_versions_on_gpu():
    _need_cuda()
    rng = np.random.default_rng(7)
    a = torch.from_numpy(hp.rand_fp32(rng, 1 << 16)).cuda()
    b = torch.from_numpy(hp.rand_fp32(rng, 1 << 16)).cuda()
    for op in ("div", "fdiv_rn"):
        assert torch.equal(hp.ieee(op, a, b), hp.ieee_reference(op, a, b))
    y0 = hp.ieee("rcp_approx", b)
    for fma in (False, True):
        assert torch.equal(hp.ieee("markstein", a, b, n_refine=1, fixup=True, fma=fma),
                           hp.ieee_reference("markstein", a, b, y0=y0, n_refine=1, fixup=True,
                                             fma=fma))
    table = torch.arange(640, dtype=torch.int32, device="cuda") * 7919
    for src in hp.GATHER_SRCS:
        for pattern in hp.GATHER_PATTERNS:
            got = hp.gather(src, table, shape=(96, 160), pattern=pattern, seed=3)
            assert torch.equal(got, hp.gather_reference(src, table, shape=(96, 160),
                                                        pattern=pattern, seed=3))
    hp.upload_const(table)  # the lookups alone read what the upload left
    got = hp.gather("const", table, shape=(96, 160), pattern="hashed", seed=3, upload=False)
    assert torch.equal(got, hp.gather_reference("const", table, shape=(96, 160), seed=3))
    x = torch.randn(96, 48, device="cuda")
    w = torch.randn(48, 40, device="cuda")
    assert torch.equal(hp.dot(x, w, prec="fp32"), hp.dot_reference(x, w, prec="fp32"))
    for prec in ("bf16", "bf16x3"):
        p = hp.dot_reference(x, w, prec=prec)
        assert (hp.dot(x, w, prec=prec) - p).abs().max() <= 1e-5 * p.abs().max()
    h = hp.dot(x, w, prec="bf16", tanh=True, round_bf16=True)
    p = hp.dot_reference(x, w, prec="bf16", tanh=True, round_bf16=True)
    assert (h - p).abs().max() <= 2.0 ** -8 and (h != p).float().mean() <= hp.BF16_TANH_MISMATCH
    assert torch.equal(h, h.bfloat16().float())
    plane = torch.randn(8, 512, device="cuda")
    for n_rows in hp.CONCAT_ROWS:
        for bf16 in (False, True):
            assert torch.equal(hp.concat(plane, n_rows, bf16=bf16),
                               hp.concat_reference(plane, n_rows, bf16=bf16))
    assert torch.equal(hp.concat(plane, 16, 8), hp.concat_reference(plane, 16, 8))
