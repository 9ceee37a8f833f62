"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Marked ``gpu``: they skip without a card (decided inside the
fixture, never at import). On the card:
``python -m pytest -m gpu tests/test_torch_kernels.py``."""

import importlib

import pytest
import torch

tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def _block(gen, c, heads, ws, dtype, dev):
    hid = 2 * c
    w = dict(norm1_w=1 + _randn(gen, c, scale=0.1),
             norm1_b=_randn(gen, c, scale=0.1),
             qkv_w=_randn(gen, 3 * c, c, scale=c ** -0.5),
             qkv_b=_randn(gen, 3 * c, scale=0.1),
             proj_w=_randn(gen, c, c, scale=c ** -0.5),
             proj_b=_randn(gen, c, scale=0.1),
             rpb_table=_randn(gen, (2 * ws - 1) ** 2, heads, scale=0.5),
             norm2_w=1 + _randn(gen, c, scale=0.1),
             norm2_b=_randn(gen, c, scale=0.1),
             fc1_w=_randn(gen, hid, c, scale=c ** -0.5),
             fc1_b=_randn(gen, hid, scale=0.1),
             fc2_w=_randn(gen, c, hid, scale=hid ** -0.5),
             fc2_b=_randn(gen, c, scale=0.1))
    return tsb.prepare_swin_params(**{k: v.to(dev) for k, v in w.items()},
                                   num_heads=heads, ws=ws, dtype=dtype)


@pytest.mark.parametrize("ws,c,heads,hw", [
    (8, 180, 6, (32, 48)), (8, 180, 6, (24, 40)), (7, 48, 3, (21, 28)),
    (4, 8, 2, (16, 16))])
@pytest.mark.parametrize("dc_kind", ["zero", "neg", "pos"])
def test_swin_block_kernel_matches_plain_f32(cuda, ws, c, heads, hw,
                                            dc_kind):
    gen = torch.Generator().manual_seed(0)
    s = ws // 2
    dc = {"zero": 0, "neg": -s, "pos": s}[dc_kind]
    x = _randn(gen, 2, *hw, c).to(cuda)
    p = _block(gen, c, heads, ws, torch.float32, cuda)
    n = ws * ws
    bank = None if dc == 0 else torch.from_numpy(
        twa.shift_attention_mask(2 * ws, 2 * ws, ws, s)
        .reshape(2, 2, n, n)).to(cuda)
    kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bank)
    n0 = tsb.swin_block.launches
    got = tsb.swin_block(x, p, **kw)
    assert tsb.swin_block.launches == n0 + 1
    want = tsb.swin_block_plain(x, p, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ws,c,heads,hw", [
    (8, 180, 6, (32, 48)), (8, 180, 6, (24, 40)), (7, 48, 3, (21, 28)),
    (4, 8, 2, (16, 16))])
@pytest.mark.parametrize("fast", [False, True])
def test_swin_block_kernel_bf16_within_rounding(cuda, ws, c, heads, hw,
                                                fast):
    """bf16 (tensor cores): the RMS error against the plain bf16 version is
    no larger than plain bf16's against plain f32 (the rounding control)."""
    gen = torch.Generator().manual_seed(2)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    state = gen.get_state()
    p16 = _block(gen, c, heads, ws, torch.bfloat16, cuda)
    gen.set_state(state)
    p32 = _block(gen, c, heads, ws, torch.float32, cuda)
    s = ws // 2
    n = ws * ws
    bank = torch.from_numpy(twa.shift_attention_mask(2 * ws, 2 * ws, ws, s)
                            .reshape(2, 2, n, n)).to(cuda)
    kw = dict(num_heads=heads, ws=ws, dc=-s, mask_bank=bank, fast=fast)
    x16 = x32.to(torch.bfloat16)
    got = tsb.swin_block(x16, p16, **kw).float()
    want = tsb.swin_block_plain(x16, p16, **kw).float()
    ref = tsb.swin_block_plain(x32, p32, **kw)
    rms = (got - want).square().mean().sqrt()
    ctrl = (want - ref).square().mean().sqrt()
    assert torch.isfinite(got).all() and rms <= ctrl, (rms, ctrl)


@pytest.mark.parametrize("case", [
    dict(cin=3, cout=180), dict(cin=180, cout=180, roll=4, res=True),
    dict(cin=180, cout=180, ln=True, res=True),
    dict(cin=180, cout=64, act="lrelu"), dict(cin=20, cout=70, roll=-7),
    dict(cin=16, cout=16, act="lrelu2", roll=13)])
def test_conv3x3_kernel_matches_plain_f32(cuda, case):
    gen = torch.Generator().manual_seed(1)
    cin, cout = case["cin"], case["cout"]
    x = _randn(gen, 2, 19, 70, cin).to(cuda)
    w = _randn(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(cuda)
    b = _randn(gen, cout, scale=0.1).to(cuda)
    kw = dict(act=case.get("act"), roll=case.get("roll", 0))
    if case.get("res"):
        kw["res"] = _randn(gen, 2, 19, 70, cout).to(cuda)
    if case.get("ln"):
        kw["ln_pre"] = (1 + _randn(gen, cin, scale=0.1).to(cuda),
                        _randn(gen, cin, scale=0.1).to(cuda))
    got = tconv.conv3x3(x, w, b, **kw)
    want = tconv.conv3x3_plain(x, w, b, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # bf16 (tensor cores): within the bf16 rounding control in RMS
    kw16 = dict(kw)
    if "res" in kw:
        kw16["res"] = kw["res"].to(torch.bfloat16)
    got16 = tconv.conv3x3(x.to(torch.bfloat16), w, b, **kw16).float()
    want16 = tconv.conv3x3_plain(x.to(torch.bfloat16), w, b, **kw16).float()
    rms = (got16 - want16).square().mean().sqrt()
    ctrl = (want16 - want).square().mean().sqrt()
    assert torch.isfinite(got16).all() and rms <= ctrl, (rms, ctrl)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tconv.conv3x3(x, torch.zeros(3, 3, 4, 4, device=cuda))
    qkv = torch.zeros(81 * 2, 3 * 8, device=cuda)
    rpb = torch.zeros(2, 81, 81, device=cuda)
    with pytest.raises(ValueError):  # N = 81 > 64
        tsb.window_attention(qkv, rpb, None, num_heads=2, nwy=1, nwx=2,
                             fast=False)
