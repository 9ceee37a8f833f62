"""The port's weight pipeline (``image_restoration_agent_tpu_torch
.convert``: the manifest, ``convert_checkpoint``, the checkpoint reader
and the MAXIM converter; ``offline.validate_weights``) against the JAX
package's on the CPU.

Each family with a torch transcription in ``tests/test_convert_<model>.py``
(the published architecture's names) saves its tiny state in the wrapper
the real checkpoint ships in; the port converts it with a strict load into
its own module, and its forward is held against the JAX model's on the
JAX package's conversion of the same file, to 1e-5 of the output's
largest magnitude in float32."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.convert import torch_import as jti
from image_restoration_agent_tpu.convert.iqa_rules import (maniqa_rules,
                                                           musiq_rules)
from image_restoration_agent_tpu.convert.manifest import MANIFEST as JMANIFEST
from image_restoration_agent_tpu.convert.maxim_rules import (
    convert_maxim as jconvert_maxim)
from image_restoration_agent_tpu.convert.maxim_rules import (
    maxim_name_map as jname_map)
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.convert import manifest as tman
from image_restoration_agent_tpu_torch.convert import maxim_rules as tmaxim
from image_restoration_agent_tpu_torch.convert import torch_import as tti
from image_restoration_agent_tpu_torch.convert.from_jax import from_jax
from image_restoration_agent_tpu_torch.models import build_model as tbuild

torch.set_num_threads(1)

TOL = 1e-5  # of max|ref|, float32


def _np(state) -> dict:
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach")
                          else v) for k, v in state.items()}


def _jax_template(fm, *args):
    return jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), *args))


# ---------------------------------------------------------------------------
# the families: (torch transcription's state, wrapper, JAX model and rules,
# the port's module, input)

def _swinir():
    from test_convert_swinir import TSwinIR, _state_with_reference_names
    torch.manual_seed(0)
    state = _state_with_reference_names(TSwinIR().eval())
    fm = jbuild("swinir_tiny", attention_impl="xla")
    x = np.random.default_rng(0).random((1, 16, 16, 3), dtype=np.float32)
    return dict(state=state, wrap="params", model="swinir_tiny",
                rules="swinir_rules", jax_rules=jti.swinir_rules(),
                fm=fm, template=_jax_template(fm, jnp.asarray(x)), x=x)


def _restormer():
    from test_convert_restormer import TAttn, TRestormer, _reference_names
    torch.manual_seed(0)
    tm = TRestormer().eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, TAttn):
                m.temperature.copy_(torch.rand_like(m.temperature) + 0.5)
    fm = jbuild("restormer_tiny")
    x = np.random.default_rng(1).random((1, 16, 16, 3), dtype=np.float32)
    return dict(state=_reference_names(tm), wrap="params",
                model="restormer_tiny", rules="restormer_rules",
                jax_rules=jti.restormer_rules(), fm=fm,
                template=_jax_template(fm, jnp.asarray(x)), x=x)


def _fbcnn():
    from test_convert_fbcnn import NB, TFBCNN, _reference_names
    torch.manual_seed(0)
    fm = jbuild("fbcnn_tiny")
    x = np.random.default_rng(2).random((1, 16, 16, 3), dtype=np.float32)
    return dict(state=_reference_names(TFBCNN().eval()), wrap=None,
                model="fbcnn_tiny", rules="fbcnn_rules_for",
                jax_rules=jti.fbcnn_rules_for(NB), fm=fm,
                template=_jax_template(fm, jnp.asarray(x)), x=x)


def _mprnet():
    from test_convert_mprnet import TMPRNet
    torch.manual_seed(3)
    fm = jbuild("mprnet_tiny")
    x = np.random.default_rng(7).random((1, 16, 16, 3), dtype=np.float32)
    return dict(state=_np(TMPRNet().eval().state_dict()), wrap="state_dict",
                model="mprnet_tiny", rules="mprnet_rules",
                jax_rules=jti.mprnet_rules(), fm=fm,
                template=_jax_template(fm, jnp.asarray(x)), x=x)


def _xrestormer():
    import test_convert_xrestormer as tx
    from image_restoration_agent_tpu.models.xrestormer import XRestormer
    from image_restoration_agent_tpu_torch.models.xrestormer import (
        XRestormer as PXRestormer)
    torch.manual_seed(0)
    tm = tx.TXRestormer().eval()
    with torch.no_grad():
        for p in tm.parameters():
            if p.ndim == 1:
                p.add_(torch.randn_like(p) * 0.05)
    cfg = dict(dim=tx.DIM, num_blocks=tx.BLOCKS,
               num_refinement_blocks=tx.REFINE, channel_heads=tx.CH_HEADS,
               spatial_heads=tx.SP_HEADS, overlap_ratio=(tx.OVER,) * 4,
               window_size=tx.WS, spatial_dim_head=tx.DIM_HEAD,
               ffn_expansion_factor=tx.EXP)
    fm = XRestormer(**cfg)
    x = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
    return dict(state=_np(tm.state_dict()), wrap="params",
                model="xrestormer", rules="xrestormer_rules",
                jax_rules=jti.xrestormer_rules(), fm=fm,
                template=_jax_template(fm, jnp.asarray(x)),
                port=lambda: PXRestormer(**cfg), x=x)


def _ifan():
    from test_convert_ifan import TIFAN
    from image_restoration_agent_tpu.models.ifan import IFAN
    from image_restoration_agent_tpu_torch.models.ifan import IFAN as PIFAN
    torch.manual_seed(0)
    fm = IFAN(ch=8, res_num=1, n_iters=2, filter_size=3)
    x = np.random.default_rng(1).random((1, 32, 32, 3), dtype=np.float32)
    return dict(state=_np(TIFAN(ch=8, res_num=1, n_iters=2, fs=3).eval()
                          .state_dict()), wrap=None, model="ifan",
                rules="ifan_rules", jax_rules=jti.ifan_rules(1), fm=fm,
                template=_jax_template(fm, jnp.asarray(x)),
                port=lambda: PIFAN(ch=8, res_num=1, filter_size=3,
                                   n_iters=2), x=x)


def _ridcp():
    import test_convert_ridcp as tr
    from image_restoration_agent_tpu.models.ridcp import RIDCP
    from image_restoration_agent_tpu_torch.models.ridcp import (
        RIDCP as PRIDCP)
    torch.manual_seed(0)
    cfg = dict(n_embed=tr.N_E, embed_dim=tr.E_DIM, max_depth=tr.MAX_DEPTH,
               swin_blocks=tr.SWIN_BLOCKS, swin_depth=tr.SWIN_DEPTH,
               swin_heads=tr.SWIN_HEADS, weight_alpha=tr.ALPHA,
               channels=tr.CQ)
    fm = RIDCP(**cfg)
    x = np.random.default_rng(4).random((1, 64, 64, 3), dtype=np.float32)
    return dict(state=_np(tr.TRIDCP().eval().state_dict()), wrap="params",
                model="ridcp", rules="ridcp_rules",
                jax_rules=jti.ridcp_rules(tr.MAX_DEPTH, tr.SWIN_BLOCKS),
                fm=fm, template=_jax_template(fm, jnp.asarray(x)),
                port=lambda: PRIDCP(**cfg), x=x)


def _maniqa():
    import test_convert_maniqa as tm_
    from image_restoration_agent_tpu_torch.iqa.maniqa import MANIQA
    torch.manual_seed(0)
    fm = tm_._mini_flax()
    x = (np.random.default_rng(0).standard_normal(
        (2, tm_.IMG, tm_.IMG, 3)) * 0.3).astype(np.float32)
    cfg = dict(embed_dim=tm_.EMBED, patch_size=tm_.PATCH,
               img_size=tm_.IMG, depths=tm_.DEPTHS, num_heads=tm_.HEADS,
               window_size=tm_.WS, dim_mlp=tm_.DIM_MLP, num_tab=2,
               scale=tm_.SCALE, vit_depth=tm_.VIT_DEPTH,
               vit_heads=tm_.VIT_HEADS, feature_blocks=tm_.TAPS)
    return dict(state=_np(tm_.TMANIQA().eval().state_dict()), wrap=None,
                model="maniqa", rules="maniqa_rules",
                jax_rules=maniqa_rules(), fm=fm,
                template=_jax_template(fm, jnp.asarray(x))["params"],
                port=lambda: MANIQA(**cfg), x=x, nest=True)


def _musiq():
    import test_convert_musiq as tq
    from image_restoration_agent_tpu.iqa import musiq as mq
    from image_restoration_agent_tpu_torch.iqa.musiq import MUSIQ
    torch.manual_seed(0)
    fm = tq._mini_flax()
    rng = np.random.default_rng(0)
    p1 = rng.standard_normal((1, 6, mq.PATCH * mq.PATCH * 3)) \
        .astype(np.float32)
    p2 = rng.standard_normal((1, 2, mq.PATCH * mq.PATCH * 3)) \
        .astype(np.float32)
    hidx = np.array([0, 5, 11, 23, 47, 99, 3, 88], np.int32)
    sidx = np.array([0] * 6 + [1] * 2, np.int32)
    jargs = ([jnp.asarray(p1), jnp.asarray(p2)], jnp.asarray(hidx),
             jnp.asarray(sidx))
    targs = ([torch.from_numpy(p1), torch.from_numpy(p2)],
             torch.from_numpy(hidx).long(), torch.from_numpy(sidx).long())
    return dict(state=_np(tq.TMUSIQ().eval().state_dict()), wrap="params",
                model="musiq", rules="musiq_rules", jax_rules=musiq_rules(),
                fm=fm, template=_jax_template(fm, *jargs)["params"],
                port=lambda: MUSIQ(hidden=tq.HIDDEN, num_layers=tq.LAYERS,
                                   num_heads=tq.HEADS, mlp_dim=tq.MLP),
                jargs=jargs, targs=targs, nest=True)


FAMILIES = {"swinir": _swinir, "restormer": _restormer, "fbcnn": _fbcnn,
            "mprnet": _mprnet, "xrestormer": _xrestormer, "ifan": _ifan,
            "ridcp": _ridcp, "maniqa": _maniqa, "musiq": _musiq}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_converts_to_the_jax_forward(family, tmp_path):
    """The transcription's state in its checkpoint's wrapper: the port's
    ``convert_checkpoint`` (strict load into its own module, written as
    ``<model>.npz``) against the JAX converter's rules on the same file,
    forward to forward."""
    c = FAMILIES[family]()
    pth = tmp_path / f"{family}.pth"
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in c["state"].items()}
    torch.save({c["wrap"]: sd} if c["wrap"] else sd, pth)

    entry = tman.WeightEntry(c["model"], pth.name, "local", c["rules"])
    out = tman.convert_checkpoint(
        c["model"], pth, tmp_path / "w", entry=entry,
        template=c["port"]() if "port" in c else None)
    assert out == tmp_path / "w" / f"{c['model']}.npz"
    port = c["port"]() if "port" in c else tbuild(c["model"], device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          tti.read_state(out).items()}, strict=True)
    port.eval()

    jstate = jti.load_torch_checkpoint(pth)
    params = jti.convert_with_drops(jstate, c["jax_rules"], c["template"])
    if c.get("nest"):
        params = {"params": params}
    jargs = c["jargs"] if "jargs" in c else (jnp.asarray(c["x"]),)
    want = np.asarray(jax.jit(c["fm"].apply)(params, *jargs))
    targs = c["targs"] if "targs" in c else (torch.from_numpy(c["x"]),)
    with torch.no_grad():
        got = port(*targs).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (family, err)


def test_strict_load_refuses_a_wrong_checkpoint(tmp_path):
    """The template check: a missing parameter, or one of another shape,
    is refused."""
    from test_convert_swinir import TSwinIR, _state_with_reference_names

    torch.manual_seed(0)
    state = _state_with_reference_names(TSwinIR().eval())
    entry = tman.WeightEntry("swinir_tiny", "s.pth", "local", "swinir_rules")
    k = next(k for k in state if k.endswith("qkv.weight"))
    for bad in ({x: v for x, v in state.items() if x != k},
                {**state, k: state[k][:-1]}):
        torch.save({"params": {x: torch.from_numpy(v)
                               for x, v in bad.items()}}, tmp_path / "s.pth")
        with pytest.raises(RuntimeError):
            tman.convert_checkpoint("swinir_tiny", tmp_path / "s.pth",
                                    tmp_path / "w", entry=entry)


# ---------------------------------------------------------------------------
# the copies of the JAX package's tables


def test_manifest_is_the_jax_packages():
    assert [dataclasses.astuple(e) for e in tman.MANIFEST] == \
        [dataclasses.astuple(e) for e in JMANIFEST]
    assert tman.get_entry("maxim_s3").rules is None
    with pytest.raises(KeyError):
        tman.get_entry("no_such_model")


@pytest.mark.parametrize("cfg", [{}, {"num_stages": 3},
                                 {"num_stages": 2, "depth": 2,
                                  "num_groups": 1,
                                  "num_bottleneck_blocks": 1}])
def test_maxim_name_map_is_the_jax_packages(cfg):
    assert tmaxim.maxim_name_map(**cfg) == jname_map(**cfg)


def test_every_manifest_model_has_a_port_module():
    for e in tman.MANIFEST:
        assert isinstance(tman.build_template(e.model), torch.nn.Module)


# ---------------------------------------------------------------------------
# MAXIM: the official Flax names through both converters


def test_maxim_official_tree_through_both_converters(tmp_path):
    """An official-named maxim_tiny tree (the JAX package's tree renamed
    back through the name map, random values): the port's converter gives
    the JAX converter's tree carried across, the written ``.npz`` loads
    strictly into the port's model, and the forwards agree."""
    fm = jbuild("maxim_tiny")
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    shapes = _jax_template(fm, jnp.asarray(x))["params"]
    cfg = tmaxim.name_map_config(dict(
        num_stages=2, depth=2, num_groups=1, num_bottleneck_blocks=1))
    back = {v: k for k, v in jname_map(**cfg).items()}
    rng = np.random.default_rng(1)
    flat, nested = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [p.key for p in path]
        mod, name = "/".join(names[:-1]), names[-1]
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        val = (1 + 0.1 * n) if name == "scale" else \
            (0.05 * n if name == "bias" else
             n / np.sqrt(max(np.prod(leaf.shape[:-1]), 1)))
        key = f"{back[mod]}/{name}"
        flat[key] = val.astype(np.float32)
        node = nested
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    want = jconvert_maxim(nested, **cfg)
    got = tmaxim.convert_maxim(flat, **cfg)
    carried = from_jax(want)
    assert set(got) == set(carried)
    for k in got:
        torch.testing.assert_close(got[k], carried[k], rtol=0, atol=0)

    npz = tmp_path / "maxim_tiny_official.npz"
    np.savez(npz, **{f"opt/target/{k}": v for k, v in flat.items()},
             **{"opt/state/step": np.zeros(())})
    entry = tman.WeightEntry("maxim_tiny", npz.name, "local", None)
    out = tman.convert_checkpoint("maxim_tiny", npz, tmp_path / "w",
                                  entry=entry)
    port = tbuild("maxim_tiny", device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          tti.read_state(out).items()}, strict=True)
    ref = np.asarray(jax.jit(fm.apply)(want, jnp.asarray(x)))
    with torch.no_grad():
        out_t = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(out_t - ref).max() <= TOL * np.abs(ref).max()
    with pytest.raises(KeyError, match="opt/target"):
        np.savez(tmp_path / "bare.npz", **flat)
        tmaxim.read_maxim_npz(tmp_path / "bare.npz")


# ---------------------------------------------------------------------------
# the reader: wrappers, drops, renames, formats


def test_lpips_both_naming_schemes(tmp_path):
    """The lpips package's full-model names (``net.slice{k}.{idx}``,
    ``lin{k}``) and a torchvision AlexNet trunk merged with the heads
    (``features.{idx}``, ``lins.{k}``), with the scaling-layer buffers,
    convert to the same state; its LPIPS agrees with the JAX LPIPS on the
    JAX converter's params."""
    from image_restoration_agent_tpu.iqa.lpips import LPIPS as JLPIPS
    from image_restoration_agent_tpu_torch.iqa.lpips import LPIPS

    rng = np.random.default_rng(5)
    full = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in LPIPS().state_dict().items()}
    full = {k: np.abs(v) if k.startswith("lin") else v
            for k, v in full.items()}
    idx = {1: 0, 2: 3, 3: 6, 4: 8, 5: 10}
    tv = {}
    for k, v in full.items():
        if k.startswith("net.slice"):
            s, rest = k[len("net.slice"):].split(".", 1)
            tv[f"features.{rest}"] = v
            assert rest.startswith(f"{idx[int(s)]}.")
        else:
            tv["lins." + k[len("lin"):]] = v
    extra = {"scaling_layer.shift": np.zeros((1, 3, 1, 1), np.float32),
             "scaling_layer.scale": np.ones((1, 3, 1, 1), np.float32)}
    outs = []
    for name, st in (("full", full), ("torchvision", tv)):
        pth = tmp_path / f"{name}.pth"
        torch.save({k: torch.from_numpy(v)
                    for k, v in {**st, **extra}.items()}, pth)
        outs.append(tti.read_state(tman.convert_checkpoint(
            "lpips_alex", pth, tmp_path / name)))
    assert outs[0].keys() == outs[1].keys() == full.keys()
    for k in full:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])

    params = jti.convert_with_drops(
        {**full, **extra}, jti.lpips_rules(), _jax_template(
            JLPIPS(), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))
    a, b = np.random.default_rng(6).random((2, 1, 32, 32, 3),
                                           dtype=np.float32)
    want = np.asarray(JLPIPS().apply(params, jnp.asarray(a),
                                     jnp.asarray(b)))
    model = LPIPS()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in outs[0].items()}, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("wrap", [None, "params_ema", "params",
                                  "state_dict", "model"])
def test_checkpoint_wrappers_match_jax(wrap, tmp_path):
    """One reader for the converter and the engine: the reference's
    wrapper selection, as the JAX package's loader makes it; bfloat16
    widened."""
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3),
          "b": torch.ones(3)}
    torch.save({wrap: sd, "other": {"x": torch.zeros(1)}} if wrap else sd,
               tmp_path / "c.pth")
    got = tti.load_torch_checkpoint(tmp_path / "c.pth")
    want = jti.load_torch_checkpoint(tmp_path / "c.pth")
    assert got.keys() == want.keys() == {"a.weight", "b"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tti.read_state(tmp_path / "c.pth").keys() == got.keys()
    # numpy has no bfloat16: widened to float32 (the JAX loader raises)
    torch.save({"b": torch.ones(3, dtype=torch.bfloat16)}, tmp_path / "h.pt")
    assert tti.load_torch_checkpoint(tmp_path / "h.pt")["b"].dtype == \
        np.float32
    # only safe unpickling: a file weights_only=True refuses raises
    (tmp_path / "bad.pth").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="weights_only=True"):
        tti.load_torch_checkpoint(tmp_path / "bad.pth")


def test_read_state_formats(tmp_path):
    """The one weight format, a reference-named state dict, reads the same
    from a wrapped ``.pth`` and from the ``.npz`` ``convert_checkpoint``
    writes."""
    rng = np.random.default_rng(3)
    want = {"conv_first.weight": rng.standard_normal((4, 3, 3, 3),
                                                     dtype=np.float32),
            "conv_first.bias": rng.standard_normal(4, dtype=np.float32),
            "norm.running_var": np.ones(4, np.float32)}
    torch.save({"params_ema": {k: torch.from_numpy(v)
                               for k, v in want.items()}},
               tmp_path / "sd.pth")
    np.savez(tmp_path / "sd.npz", **want)
    for name in ("sd.pth", "sd.npz"):
        got = tti.read_state(tmp_path / name)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_family_drops(tmp_path):
    """The keys the JAX rule sets drop on purpose: buffers the port
    recomputes, CLIP's metadata, the Combiner's logit scale, MANIQA's ViT
    head; buffers the port's module holds are kept."""
    st = {"layers.0.attn.relative_position_index": 1, "attn_mask": 2,
          "x.relative_positions": 3, "conv.weight": 4}
    assert tti.reference_state(st) == {"conv.weight": 4}
    assert tti.reference_state(
        st, keep=["layers.0.attn.relative_position_index"]) == {
        "layers.0.attn.relative_position_index": 1, "conv.weight": 4}
    assert tti.reference_state({"input_resolution": 1, "context_length": 2,
                                "vocab_size": 3, "logit_scale": 4},
                               "clip_rules") == {"logit_scale": 4}
    assert tti.reference_state({"logit_scale": 1, "output_layer.bias": 2},
                               "combiner_rules") == {"output_layer.bias": 2}
    assert tti.reference_state({"vit.norm.weight": 1, "vit.head.bias": 2,
                                "vit.blocks.0.norm1.weight": 3},
                               "maniqa_rules") == {
        "vit.blocks.0.norm1.weight": 3}


# ---------------------------------------------------------------------------
# validate-weights


def test_validate_tiny_swinir(tmp_path, monkeypatch):
    """``validate`` on the tiny TSwinIR checkpoint of
    ``test_validate_weights.py``: converted through the manifest path,
    served through the tiled path on the CPU, scored against the
    transcription's own output; the absent entry is ``missing``."""
    from test_validate_weights import _make_ckpt

    from image_restoration_agent_tpu_torch.core.io import save_image
    from image_restoration_agent_tpu_torch.offline import (
        validate_weights as vw)

    tm, ckpt_dir = _make_ckpt(tmp_path)
    img = np.random.default_rng(0).random((16, 16, 3), dtype=np.float32)
    pad = np.pad(img, ((0, 8), (0, 8), (0, 0)), mode="symmetric")
    with torch.no_grad():
        want = tm(torch.from_numpy(
            pad[None].transpose(0, 3, 1, 2))).numpy()[0].transpose(1, 2, 0)
    groot = tmp_path / "goldens" / "tiny"
    groot.mkdir(parents=True)
    save_image(img, groot / "input.png")
    save_image(np.clip(want[: 16 * 4, : 16 * 4], 0, 1),
               groot / "expected.png")
    (groot / "model.txt").write_text("swinir_tiny")
    monkeypatch.setattr(vw, "GOLDEN_ROOT", tmp_path / "goldens")

    manifest = [
        tman.WeightEntry("swinir_tiny", "tiny_swinir.pth", "local",
                         "swinir_rules"),
        tman.WeightEntry("swinir_sr_x4", "not_downloaded.pth", "local",
                         "swinir_rules"),
    ]
    report = vw.validate(ckpt_dir, tmp_path / "weights", manifest=manifest,
                         device="cpu")
    by_model = {r["model"]: r for r in report["records"]}
    assert by_model["swinir_sr_x4"]["status"] == "missing"
    rec = by_model["swinir_tiny"]
    assert rec["status"] == "pass", rec
    assert rec["golden"] == "tiny" and rec["shape_ok"]
    assert rec["golden_psnr_db"] > 45.0
    assert rec["converted"].endswith("swinir_tiny.npz")
    rj = json.loads((tmp_path / "weights" / "validate_report.json")
                    .read_text())
    assert rj == report and (rj["pass"], rj["missing"]) == (1, 1)
    assert (tmp_path / "weights" / "validate_report.md").read_text() \
        .startswith("| model | status | golden PSNR (dB) | shape |")


def test_goldens_and_orientation_are_the_jax_packages():
    from image_restoration_agent_tpu.offline import validate_weights as jvw
    from image_restoration_agent_tpu_torch.offline import (
        validate_weights as vw)

    assert vw.GOLDEN_ROOT == jvw.GOLDEN_ROOT
    assert vw.GOLDEN_PSNR_TOL_DB == jvw.GOLDEN_PSNR_TOL_DB
    got, want = vw._goldens(), jvw._goldens()
    assert {k: v["model"] for k, v in got.items()} == \
        {k: v["model"] for k, v in want.items()}
    rng = np.random.default_rng(0)
    a = rng.random((8, 12, 3), dtype=np.float32)
    ref = np.rot90(a + 0.01, 1)
    np.testing.assert_allclose(vw.best_orientation_psnr(a, ref),
                               jvw.best_orientation_psnr(a, ref),
                               rtol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["nafnet_synth", "fbcnn_synth",
                                  "restormer_synth", "swinir_sr_x4_synth"])
def test_synthetic_golden_gate_on_the_port(name, tmp_path):
    """The four committed real-geometry goldens through the port's
    converter and tiled path on the CPU, at the recorded PSNR - 0.1 dB."""
    from image_restoration_agent_tpu_torch.offline import (
        list_synthetic_goldens, run_synthetic_golden)

    torch.set_num_threads(4)
    dirs = {d.name: d for d in list_synthetic_goldens()}
    rec = run_synthetic_golden(dirs[name], weight_root=tmp_path,
                               device="cpu")
    assert rec["status"] == "pass", rec
    assert rec["golden_psnr_db"] >= rec["want_db"] - 0.1
    assert (tmp_path / f"{rec['model']}.npz").exists()


def test_jax_maxim_manifest_fault_is_pinned(tmp_path):
    """The JAX package's ``convert_checkpoint`` hands the official MAXIM
    file's path to ``convert_maxim``, which takes the parameter tree, and
    raises; the port reads the file. A minimal official file: one leaf,
    which the port's reader returns and its name map knows."""
    from image_restoration_agent_tpu.convert.manifest import (
        convert_checkpoint as jconvert)

    leaf = np.zeros((3, 3, 3, 32), np.float32)
    npz = tmp_path / "maxim_s3_dehazing_sots-indoor.npz"
    np.savez(npz, **{"opt/target/stage_0_input_conv_0/kernel": leaf})
    with pytest.raises(AttributeError, match="items"):
        jconvert("maxim_s3", npz, tmp_path / "j")
    flat = tmaxim.read_maxim_npz(npz)
    assert list(flat) == ["stage_0_input_conv_0/kernel"]
    got = tmaxim.convert_maxim(flat, **tmaxim.name_map_config({}))
    assert list(got) == ["stage0_input_conv_0.weight"]
    assert tuple(got["stage0_input_conv_0.weight"].shape) == (32, 3, 3, 3)
