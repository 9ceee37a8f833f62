"""Port parity for slice 5, the lab path: K7 ``conv3x3_pair``, K8
``swin_pair_block`` and ``lab_strip`` (plain versions against the JAX
package's Pallas kernels in interpret mode), the strip-tuple weight
carry-over, and the lab entry points of image_restoration_agent_tpu_torch
on the CPU."""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from image_restoration_agent_tpu_torch.convert import strip_block_params
from image_restoration_agent_tpu_torch.lab import head_pair, kernel_lab, lab_r5

jconv = importlib.import_module("image_restoration_agent_tpu.ops.conv3x3")
jpa = importlib.import_module(
    "image_restoration_agent_tpu.ops.pallas_attention")
jwa = importlib.import_module(
    "image_restoration_agent_tpu.ops.window_attention")
tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")

torch.set_num_threads(1)

WS, C, HEADS = 4, 8, 2
S = WS // 2
N = WS * WS
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def _bf16_ulp(ref) -> float:
    """One bfloat16 ulp at the largest magnitude of ``ref``."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(ref).max()))) - 7)


def _close_f32(got, want, scale=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


def _within_bf16_control(got, want, ref32):
    """bf16: the port and the JAX package round the same function at their
    own cast points, so the port's RMS distance to the JAX bf16 output is
    held to the JAX bf16 output's own RMS error against f32 (the rounding
    control), and its largest element to the control's largest plus one
    bf16 ulp."""
    got, want, ref32 = (np.asarray(a, np.float32) for a in (got, want,
                                                             ref32))
    ctrl = want - ref32
    assert np.isfinite(got).all()
    assert _rms(got - want) <= _rms(ctrl), (_rms(got - want), _rms(ctrl))
    assert np.abs(got - want).max() <= np.abs(ctrl).max() + _bf16_ulp(
        want), (np.abs(got - want).max(), np.abs(ctrl).max())


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# K7 conv3x3_pair


def _pair_inputs(seed, w):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16 if w < 900 else 8, w, 5)).astype(
        np.float32)
    w1 = (rng.standard_normal((3, 3, 5, 7)) / 6).astype(np.float32)
    b1 = rng.standard_normal(7).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 7, 4)) / 8).astype(np.float32)
    b2 = rng.standard_normal(4).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("act", [None, "lrelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_pair_plain_matches_jax_kernel(act, dtype):
    """conv3x3_pair_plain == conv3x3_pair_pallas in interpret mode at
    (1, 16, 136, 5 -> 7 -> 4), a width the JAX kernel's chunking does not
    pad: f32 within 1e-5 x max|ref|, bf16 within one ulp at the largest
    magnitude (the same cast points: u rounded after bias and act)."""
    x, w1, b1, w2, b2 = _pair_inputs(0, 136)
    jd = getattr(jnp, dtype)
    want = jconv.conv3x3_pair_pallas(
        jnp.asarray(x).astype(jd), jnp.asarray(w1).astype(jd),
        jnp.asarray(b1), jnp.asarray(w2).astype(jd), jnp.asarray(b2),
        act_mid=act, interpret=True)
    got = tconv.conv3x3_pair(_t(x).to(getattr(torch, dtype)), _t(w1),
                             _t(b1), _t(w2), _t(b2), act_mid=act)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close_f32(got.numpy(), want)
        return
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=_bf16_ulp(want))


def test_conv3x3_pair_pads_u_with_zero_where_the_jax_kernel_does_not():
    """At W 968 the JAX kernel splits the width into two 488-column chunks
    (padded to 976) and pads u's last column with act(b1 + conv1 of the
    edge) instead of zero (ops/conv3x3.py:517-521): it differs from two
    SAME convs only in output column 967. The port equals the two convs."""
    x, w1, b1, w2, b2 = _pair_inputs(1, 968)
    xj = jnp.asarray(x)

    def conv(z, w, b):
        return jax.lax.conv_general_dilated(
            z, jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b)

    two = np.asarray(conv(conv(xj, w1, b1), w2, b2))
    got = tconv.conv3x3_pair(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    _close_f32(got.numpy(), two)
    jk = np.asarray(jconv.conv3x3_pair_pallas(
        xj, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), interpret=True))
    err = np.abs(jk - two).max(axis=(0, 1, 3))
    scale = float(np.abs(two).max())
    assert err[:967].max() <= 1e-5 * scale
    assert err[967] > 1e-2 * scale


@pytest.mark.parametrize("shape,act", [
    ((1, 12, 136, 5), None), ((1, 16, 120, 5), None),
    ((1, 16, 132, 5), None), ((1, 16, 136, 5), "relu")])
def test_conv3x3_pair_shape_rule_raises(shape, act):
    _, w1, b1, w2, b2 = _pair_inputs(2, 136)
    with pytest.raises(ValueError):
        tconv.conv3x3_pair(torch.zeros(shape), _t(w1), _t(b1), _t(w2),
                           _t(b2), act_mid=act)


def test_conv3x3_pair_kernel_form_equals_raw_weights():
    """conv3x3_pair on its kernel form (bf16: K3's packed order, Cin
    padded to 16, Cmid to 64, Cout to 8; f32 biases) == conv3x3_pair on the
    raw weights, in both dtypes."""
    x, w1, b1, w2, b2 = _pair_inputs(3, 128)
    for dtype in (torch.float32, torch.bfloat16):
        k = tconv.conv3x3_pair_weights(_t(w1), _t(b1), _t(w2), _t(b2), dtype)
        if dtype == torch.bfloat16:
            assert k.w1.shape == (1, 1, 9, 2, 8, 8, 8) \
                and k.w2.shape == (1, 4, 9, 2, 1, 8, 8)
        xx = _t(x).to(dtype)
        assert torch.equal(tconv.conv3x3_pair(xx, k, act_mid="lrelu"),
                           tconv.conv3x3_pair(xx, _t(w1), _t(b1), _t(w2),
                                              _t(b2), act_mid="lrelu"))


# ---------------------------------------------------------------------------
# K8 swin_pair_block


def _block_weights(rng):
    """Reference-layout (torch nn.Linear) weights of one block, fan-in
    scaled."""
    def mat(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.1, base=0.0):
        return (base + s * rng.standard_normal(n)).astype(np.float32)

    return dict(
        norm1_w=vec(C, 0.1, 1.0), norm1_b=vec(C), qkv_w=mat(3 * C, C),
        qkv_b=vec(3 * C), proj_w=mat(C, C), proj_b=vec(C),
        rpb_table=vec(((2 * WS - 1) ** 2, HEADS), 0.5),
        norm2_w=vec(C, 0.1, 1.0), norm2_b=vec(C), fc1_w=mat(2 * C, C),
        fc1_b=vec(2 * C), fc2_w=mat(C, 2 * C), fc2_b=vec(C))


def _strip_tuple(wts):
    """The JAX strip / pair kernels' 13-tuple of one block."""
    idx = jwa.relative_position_index(WS).reshape(-1)
    rpb = wts["rpb_table"][idx].reshape(N, N, HEADS).transpose(2, 0, 1)
    return (wts["norm1_w"], wts["norm1_b"], wts["qkv_w"].T, wts["qkv_b"],
            wts["proj_w"].T, wts["proj_b"], rpb, wts["norm2_w"],
            wts["norm2_b"], wts["fc1_w"].T, wts["fc1_b"], wts["fc2_w"].T,
            wts["fc2_b"])


def _port_params(wts, dtype):
    return tsb.prepare_swin_params(**{k: _t(v) for k, v in wts.items()},
                                   num_heads=HEADS, ws=WS, dtype=dtype)


def _bank():
    return jwa.shift_attention_mask(2 * WS, 2 * WS, WS, S).reshape(
        2, 2, N, N)


def _jax_pair(x, wa, wb, dc1, dtype):
    blk = [tuple(jnp.asarray(a) for a in _strip_tuple(w)) for w in (wa, wb)]
    return jpa.swin_pair_strip_pallas(
        jnp.asarray(x).astype(dtype), blk[0], blk[1], jnp.asarray(_bank()),
        num_heads=HEADS, ws=WS, dc1=dc1, interpret=True)


@pytest.mark.parametrize("hw", [(16, 16), (16, 32)])
@pytest.mark.parametrize("dc1", [0, S])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_pair_block_plain_matches_pair_kernel(hw, dc1, dtype):
    """swin_pair_block_plain == swin_pair_strip_pallas in interpret mode
    (the RSTB frame chain's two entry frames): f32 within 1e-5 x max|ref|;
    bf16 held to the rounding control (JAX bf16 against JAX f32)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, *hw, C)).astype(np.float32)
    wa, wb = _block_weights(rng), _block_weights(rng)
    td = getattr(torch, dtype)
    got = tsb.swin_pair_block(_t(x).to(td), _port_params(wa, td),
                              _port_params(wb, td), _t(_bank()),
                              num_heads=HEADS, ws=WS, dc1=dc1)
    assert got.dtype == td and got.shape == x.shape
    want = _jax_pair(x, wa, wb, dc1, getattr(jnp, dtype))
    if dtype == "float32":
        _close_f32(got.numpy(), want)
        return
    _within_bf16_control(_np(got), _np(want),
                         _jax_pair(x, wa, wb, dc1, jnp.float32))


def test_swin_pair_block_is_two_swin_blocks_and_checks_its_input():
    """On a CPU tensor swin_pair_block is swin_block(dc1) then
    swin_block(-ws/2, bank), both fast, bit for bit; an odd window count
    per row, an odd head count and a dc1 other than 0 or +ws/2 raise."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 8, 16, C)))
    pa = _port_params(_block_weights(rng), torch.float32)
    pb = _port_params(_block_weights(rng), torch.float32)
    bank = _t(_bank())
    for dc1 in (0, S):
        want = tsb.swin_block(
            tsb.swin_block(x, pa, num_heads=HEADS, ws=WS, dc=dc1,
                           fast=True), pb, num_heads=HEADS, ws=WS, dc=-S,
            mask_bank=bank, fast=True)
        got = tsb.swin_pair_block(x, pa, pb, bank, num_heads=HEADS, ws=WS,
                                  dc1=dc1)
        assert torch.equal(got, want)
    for xx, heads, dc1 in ((x[:, :, :12], HEADS, 0), (x, 1, 0), (x, HEADS, -S),
                           (x, HEADS, 1), (x[:, :6], HEADS, 0)):
        with pytest.raises(ValueError):
            tsb.swin_pair_block(xx, pa, pb, bank, num_heads=heads, ws=WS,
                                dc1=dc1)


def test_pair_form_is_the_block_head_major():
    """K8's head-major weight forms hold the block's values, per head: the
    f32 form's (swin_pair_f32_weights) q of each head, then k and v a head
    group at a time, each zero-padded to 8 columns, and proj's rows to
    match; the bf16 form's (swin_pair_weights) q of each head, then k and
    v of every head, each zero-padded to 16 columns, and proj's rows to
    match."""
    rng = np.random.default_rng(6)
    wts = _block_weights(rng)
    hd = C // HEADS
    p = _port_params(wts, torch.float32)
    f = tsb.swin_pair_f32_weights(p, HEADS)
    d = f.dims
    hdp, grp = d["hdp"], d["grp"]
    assert hdp == 8 and HEADS % grp == 0
    dense = tsb._dense(p.wqkv, C, 3 * C).reshape(C, 3, HEADS, hd)
    wq = tsb._frag_unpack(f.wq).reshape(-1, HEADS, hdp)
    assert torch.equal(wq[:C, :, :hd], dense[:, 0])
    wkv = tsb._frag_unpack(f.wkv).reshape(-1, HEADS // grp, 2, grp, hdp)
    assert torch.equal(wkv[:C, ..., :hd], dense[:, 1:].reshape(
        C, 2, HEADS // grp, grp, hd).transpose(1, 2))
    assert not wkv[..., hd:].any() and not wkv[C:].any()
    wp = tsb._frag_unpack(f.wproj).reshape(HEADS, hdp, -1)
    assert torch.equal(wp[:, :hd, :C], tsb._dense(p.wproj, C, C)
                       .reshape(HEADS, hd, C))
    assert not wp[:, hd:].any()
    p = _port_params(wts, torch.bfloat16)
    f = tsb.swin_pair_weights(p, HEADS)
    d = f.dims
    hdp = d["hdp"]
    assert hdp == 16
    dense = tsb._dense(p.wqkv, C, 3 * C).reshape(C, 3, HEADS, hd)
    wq = tsb._dense(f.wq, d["kp"], d["nq"]).reshape(-1, HEADS, hdp)
    assert torch.equal(wq[:C, :, :hd], dense[:, 0])
    assert not wq[:, :, hd:].any() and not wq[C:].any()
    wkv = tsb._dense(f.wkv, d["kp"], 2 * d["nq"]).reshape(-1, 2, HEADS, hdp)
    assert torch.equal(wkv[:C, ..., :hd], dense[:, 1:])
    assert not wkv[..., hd:].any() and not wkv[C:].any()
    wp = tsb._dense(f.wproj, d["kq"], d["nc"])[:HEADS * hdp]
    wp = wp.reshape(HEADS, hdp, -1)
    assert torch.equal(wp[:, :hd, :C], tsb._dense(p.wproj, C, C)
                       .reshape(HEADS, hd, C))
    assert not wp[:, hd:].any()


# ---------------------------------------------------------------------------
# lab_strip


def _jax_lab():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_lab", ROOT / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lab_weights(rng):
    wts = _block_weights(rng)
    return _strip_tuple(wts)[:7]


# paired and paired_staged do not run in jax 0.9's interpreter
# ('RefReshaper' object has no attribute 'indices'); they compute the same
# function as stacked, which the port's one form is held to.
@pytest.mark.parametrize("mode", ["stacked", "paired_perhead"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lab_strip_matches_jax_lab(mode, dtype):
    """lab_strip == scripts/kernel_lab.py:lab_strip in interpret mode:
    f32 within 1e-5 x max|ref|, bf16 held to the rounding control."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8, 16, C)).astype(np.float32)
    wl = _lab_weights(rng)
    lab = _jax_lab()

    def jax_lab(dt):
        with pltpu.force_tpu_interpret_mode():
            return lab.lab_strip(jnp.asarray(x).astype(dt),
                                 *map(jnp.asarray, wl), num_heads=HEADS,
                                 ws=WS, mode=mode)

    td = getattr(torch, dtype)
    got = kernel_lab.lab_strip(_t(x).to(td), *map(_t, wl), num_heads=HEADS,
                               ws=WS, mode=mode)
    assert got.dtype == td
    if dtype == "float32":
        _close_f32(got.numpy(), jax_lab(jnp.float32))
        return
    _within_bf16_control(_np(got), _np(jax_lab(jnp.bfloat16)),
                         jax_lab(jnp.float32))


def test_lab_strip_modes_and_probes():
    """The four layout modes are one function; the probes run (wrong
    result, right shape), and nownd equals noattn (no attention, per-token
    ops); the TPU-only probes raise."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 8, 16, C)))
    wl = tuple(map(_t, _lab_weights(rng)))
    kw = dict(num_heads=HEADS, ws=WS)
    ref = kernel_lab.lab_strip(x, *wl, **kw)
    for m in kernel_lab.MODES[1:]:
        assert torch.equal(kernel_lab.lab_strip(x, *wl, mode=m, **kw), ref)
    probes = {m: kernel_lab.lab_strip(x, *wl, mode=m, **kw)
              for m in kernel_lab.PROBES}
    for out in probes.values():
        assert out.shape == x.shape and torch.isfinite(out).all()
    torch.testing.assert_close(probes["nownd"], probes["noattn"], rtol=0,
                               atol=1e-6)
    for m in kernel_lab.TPU_ONLY + ("bogus",):
        with pytest.raises(ValueError):
            kernel_lab.lab_strip(x, *wl, mode=m, **kw)


# ---------------------------------------------------------------------------
# carry-over and the lab entry points


def test_strip_block_params_equals_prepare_swin_params():
    rng = np.random.default_rng(9)
    wts = _block_weights(rng)
    for dtype in (torch.float32, torch.bfloat16):
        got = strip_block_params(_strip_tuple(wts), num_heads=HEADS,
                                 dtype=dtype)
        want = _port_params(wts, dtype)
        # every kernel-form field; the bias table is kept only where the
        # caller has it (prepare_swin_params), and it rebuilds the same rpb
        for name, a, b in zip(want._fields, got, want):
            if name == "rpb_table":
                assert a is None and torch.equal(
                    b[torch.from_numpy(jwa.relative_position_index(WS)
                                       .reshape(-1).astype(np.int64))]
                    .reshape(N, N, HEADS).permute(2, 0, 1), got.rpb)
                continue
            assert a.dtype == b.dtype and torch.equal(a, b), name
    with pytest.raises(ValueError):
        strip_block_params(_strip_tuple(wts)[:7], num_heads=HEADS,
                           dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lab_r5_pair_chain_equals_sequential_chain(dtype):
    """lab_r5's 4-block RSTB frame chain on the CPU: the pair form (dc1 0,
    then +s) == the sequential form (dc 0, -s, +s, -s)."""
    blks = lab_r5.make_blocks(4, dtype, "cpu", c=C, heads=HEADS, ws=WS)
    bank = lab_r5.mask_bank(WS, "cpu")
    x = lab_r5.band_input((1, 16, 16, C), dtype, "cpu")
    kw = dict(heads=HEADS, ws=WS)
    seq = lab_r5.chain_seq(x, blks, bank, **kw)
    assert torch.equal(lab_r5.chain_pair(x, blks, bank, **kw), seq)
    assert seq.dtype == dtype and torch.isfinite(seq.float()).all()


def test_lab_entry_points_run_on_the_cpu():
    """head_pair (two K3 == the pair), lab_r5 and kernel_lab's run on the
    CPU at small shapes; the card is the default device."""
    rows = head_pair.run("cpu", ((1, 8, 128, 64),), reps=1)
    assert rows[0]["max_abs_diff"] == 0.0
    r = lab_r5.run("cpu", (1, 16, 32, 180), nblk=2, reps=1)
    assert r["max_abs_diff"] == 0.0 and r["pair_ms_per_block"] > 0
    r = kernel_lab.run("cpu", (1, 8, 16, 180), iters=1)
    assert all(r[f"{m}_max_abs_diff"] == 0.0 for m in kernel_lab.MODES[1:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            head_pair.run()
