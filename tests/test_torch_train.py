"""Port parity for the training slice: losses, schedules, the update rule
against the optax chain, the Trainer (paired crops, a 60-step denoise run,
checkpoints, kernel forms kept fresh), the classifier and retrieval
trainers, and ``Engine.profile`` under a failing body, each against the
JAX package where it has a counterpart, tolerances stated per test."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_agent_tpu.train import classifier as jcls
from image_restoration_agent_tpu.train import losses as jlosses
from image_restoration_agent_tpu.train import retrieval as jret
from image_restoration_agent_tpu.train import schedules as jsch
from image_restoration_agent_tpu.train.trainer import \
    paired_crop_stream as jstream
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.parallel.train_step import (
    UpdateRule, global_norm)
from image_restoration_agent_tpu_torch.train import (
    TrainConfig, Trainer, charbonnier_loss, cosine_annealing_restart_cyclic_lr,
    cosine_annealing_restart_lr, l1_loss, multi_step_restart_lr,
    paired_crop_stream, psnr_loss, with_gradual_warmup)
from image_restoration_agent_tpu_torch.train import classifier as tcls
from image_restoration_agent_tpu_torch.train import retrieval as tret
from image_restoration_agent_tpu_torch.train.schedules import \
    cosine_decay_schedule

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# losses and schedules


@pytest.mark.parametrize("name", ["l1_loss", "charbonnier_loss",
                                  "psnr_loss"])
def test_losses_match_jax(name):
    """Each loss on the same float32 batch within 1e-6 relative."""
    rng = np.random.default_rng(0)
    a = rng.random((2, 16, 16, 3), dtype=np.float32)
    b = rng.random((2, 16, 16, 3), dtype=np.float32)
    port = {"l1_loss": l1_loss, "charbonnier_loss": charbonnier_loss,
            "psnr_loss": psnr_loss}[name]
    want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(float(port(_t(a), _t(b))), want, rtol=1e-6)
    assert float(psnr_loss(torch.zeros(4, 4, 3), torch.full((4, 4, 3), 0.1))
                 ) == pytest.approx(-20.0, abs=1e-3)


def _schedules():
    return {
        "multi_step": dict(fn="multi_step_restart_lr", args=(1.0,),
                           kw=dict(milestones=[10, 20], gamma=0.5)),
        "multi_step_restart": dict(
            fn="multi_step_restart_lr", args=(1.0,),
            kw=dict(milestones=[10], gamma=0.5, restarts=[0, 15],
                    restart_weights=[1.0, 0.7])),
        "cosine_restart": dict(
            fn="cosine_annealing_restart_lr", args=(1.0,),
            kw=dict(periods=[100, 100], restart_weights=[1.0, 0.5],
                    eta_min=0.0)),
        "cosine_single": dict(
            fn="cosine_annealing_restart_lr", args=(1.0,),
            kw=dict(periods=[50], restart_weights=[1.0], eta_min=0.1)),
        "cosine_cyclic": dict(
            fn="cosine_annealing_restart_cyclic_lr", args=(3e-4,),
            kw=dict(periods=[10, 10], restart_weights=[1, 1],
                    eta_mins=[3e-4, 1e-6])),
    }


PORT_SCHEDULES = {"multi_step_restart_lr": multi_step_restart_lr,
                  "cosine_annealing_restart_lr": cosine_annealing_restart_lr,
                  "cosine_annealing_restart_cyclic_lr":
                      cosine_annealing_restart_cyclic_lr}


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("case", list(_schedules()))
def test_schedules_match_jax(case, warmup):
    """Each schedule (and with ``with_gradual_warmup``, multiplier 2)
    against the JAX one over every step of its periods and 10 past them
    (the multi-step ones over 0..230), within 1e-6 x the schedule's base
    rate: the JAX schedules evaluate in float32, where ``1 + cos`` near a
    period's end cancels the cosine's last bits; the port evaluates in
    float64. The boundaries are held exactly in the next test."""
    c = _schedules()[case]
    jf = getattr(jsch, c["fn"])(*c["args"], **c["kw"])
    tf = PORT_SCHEDULES[c["fn"]](*c["args"], **c["kw"])
    if warmup:
        jf = jsch.with_gradual_warmup(jf, warmup, multiplier=2.0)
        tf = with_gradual_warmup(tf, warmup, multiplier=2.0)
    base = c["args"][0]
    for step in range(sum(c["kw"].get("periods", [220])) + 11):
        want = float(jf(step))
        assert tf(step) == pytest.approx(want, rel=0, abs=1e-6 * base), step


def test_schedule_boundaries_of_the_jax_tests():
    """The boundary values ``tests/test_train.py`` checks for JAX."""
    f = multi_step_restart_lr(1.0, milestones=[10, 20], gamma=0.5)
    assert (f(0), f(9), f(10), f(19), f(20), f(25)) == (1.0, 1.0, 0.5, 0.5,
                                                        0.25, 0.25)
    f = multi_step_restart_lr(1.0, milestones=[10], gamma=0.5,
                              restarts=[15], restart_weights=[0.7])
    assert f(15) == pytest.approx(0.7) and f(16) == 0.5
    f = cosine_annealing_restart_lr(1.0, periods=[100, 100],
                                    restart_weights=[1.0, 0.5], eta_min=0.0)
    assert f(0) == 1.0 and f(50) == pytest.approx(0.5)
    assert f(100) == pytest.approx(0.0, abs=1e-9)
    assert 0.4 < f(101) <= 0.5
    f = cosine_annealing_restart_cyclic_lr(3e-4, periods=[10, 10],
                                           restart_weights=[1, 1],
                                           eta_mins=[3e-4, 1e-6])
    assert f(5) == pytest.approx(3e-4)
    assert f(20) == pytest.approx(1e-6, rel=1e-3)
    f = cosine_decay_schedule(3e-4, 100, 0.05)
    g = optax.cosine_decay_schedule(3e-4, 100, 0.05)
    for s in (0, 1, 50, 99, 100, 150):
        assert f(s) == pytest.approx(float(g(s)), rel=1e-6)


# ---------------------------------------------------------------------------
# the update rule


@pytest.mark.parametrize("clip, decay, trigger", [
    (0.0, 0.0, "none"), (1.0, 0.0, "clipped"), (50.0, 0.0, "unclipped"),
    (1.0, 1e-2, "clipped")])
def test_update_rule_matches_the_optax_chain(clip, decay, trigger):
    """The JAX Trainer's chain (clip_by_global_norm -> scale_by_adam ->
    add_decayed_weights -> scale_by_schedule(-lr), the schedule read at
    the count before each update) on identical gradients for 5 steps: the
    parameters within 2e-7 x (1 + |p|) after every step (float32
    rounding; both compute in float32, in other fused orders). The
    gradients are handed in, not computed: near-zero gradient noise would
    become full-size Adam steps."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3, 3, 3), (7,), (5, 6)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = cosine_annealing_restart_lr(1e-2, periods=[3, 3],
                                        restart_weights=[1.0, 0.5])
    jsched = jsch.cosine_annealing_restart_lr(1e-2, periods=[3, 3],
                                              restart_weights=[1.0, 0.5])
    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.scale_by_adam()] + (
        [optax.add_decayed_weights(decay)] if decay else []) + [
        optax.scale_by_schedule(lambda s: -jsched(s))]
    tx = optax.chain(*parts)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    rule = UpdateRule(sched, grad_clip=clip, weight_decay=decay)
    tp = [_t(p.copy()) for p in params]
    tstate = rule.init(tp)
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) * 3
                 for s in shapes]
        norm = float(global_norm([_t(g) for g in grads]))
        if trigger == "clipped":
            assert norm > clip
        elif trigger == "unclipped":
            assert norm < clip
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        rule.update(tp, [_t(g) for g in grads], tstate)
        assert tstate.count == step + 1
        for a, b in zip(tp, jp):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b,
                                       atol=2e-7 * (1 + np.abs(b).max()),
                                       rtol=0)


def test_update_rule_writes_in_place():
    """Parameters are updated in place, so ``_version`` moves (the kernel
    forms' cache key); never through ``.data``."""
    m = build_model("nafnet_small", device="cpu", width=8,
                    enc_blk_nums=(1,), dec_blk_nums=(1,))
    params = list(m.parameters())
    before = [p._version for p in params]
    rule = UpdateRule(1e-3)
    rule.update(params, [torch.ones_like(p) for p in params],
                rule.init(params))
    assert all(p._version > v for p, v in zip(params, before))


# ---------------------------------------------------------------------------
# the Trainer


def _degrade(patch, drng):
    noisy = patch.astype(np.float32) + drng.normal(0, 25, patch.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _hq(seed=0, n=4, size=64):
    rng = np.random.default_rng(seed)
    return [(rng.random((size, size, 3)) * 255).astype(np.uint8)
            for _ in range(n)]


def test_paired_crop_stream_is_bit_equal_to_jax():
    """Same seed, same crops and degradations (the rng draw order kept)."""
    hq = _hq(1, n=3, size=48)
    a, b = jstream(hq, _degrade, 4, 16, seed=5), \
        paired_crop_stream(hq, _degrade, 4, 16, seed=5)
    for _ in range(3):
        (jl, jh), (tl, th) = next(a), next(b)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(th, jh)


NAF = dict(width=8, enc_blk_nums=(1,), dec_blk_nums=(1,))


def test_denoise_training_improves(tmp_path):
    """The JAX test's recipe on the port: tiny NAFNet, 60 steps of
    synthetic denoising (batch 4, crop 32, lr 1e-3); the loss falls below
    half its first value, and validation runs at its step."""
    model = build_model("nafnet_small", device="cpu", **NAF)
    cfg = TrainConfig(total_iters=60, batch_size=4, crop_size=32,
                      base_lr=1e-3, log_freq=10, val_freq=60, save_freq=1000)
    tr = Trainer(model, cfg, work_dir=tmp_path, device="cpu")
    hq = _hq()
    lq_val = _degrade(hq[0][:32, :32], np.random.default_rng(9))
    val = [(lq_val.astype(np.float32) / 255,
            hq[0][:32, :32].astype(np.float32) / 255)]
    state = tr.fit(paired_crop_stream(hq, _degrade, 4, 32, seed=1),
                   val_pairs=val)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert state.step == 60 and losses[-1] < 0.5 * losses[0]
    val_db = [h["val_psnr"] for h in tr.history if "val_psnr" in h]
    assert len(val_db) == 1 and np.isfinite(val_db[0])
    assert json.loads((tmp_path / "history.json").read_text()) == tr.history


def test_checkpoint_round_trip(tmp_path):
    """``ckpt_<step>.pth`` is the reference-named state dict; loading it
    (``weights_only``, ``strict``) restores every tensor exactly."""
    model = build_model("nafnet_small", device="cpu", **NAF)
    tr = Trainer(model, TrainConfig(total_iters=2, batch_size=2,
                                    crop_size=16), work_dir=tmp_path,
                 device="cpu")
    state = tr.fit(paired_crop_stream(_hq(), _degrade, 2, 16))
    path = tr.save_checkpoint(state, 2)
    assert path.name == "ckpt_2.pth"
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = build_model("nafnet_small", device="cpu", seed=5, **NAF)
    tr2 = Trainer(fresh, TrainConfig(), work_dir=tmp_path, device="cpu")
    sd = tr2.load_checkpoint(path)
    assert sorted(sd) == sorted(saved)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)


def test_kernel_forms_follow_the_step(tmp_path):
    """The stale-form guard: after a step (in-place updates bump
    ``_version``), the model's forward equals a fresh model loaded with the
    stepped state dict, and every cached K3, K4 and K5 form equals one made
    anew from the stepped weights."""
    model = build_model("restormer_tiny", device="cpu")
    x = np.random.default_rng(2).random((2, 16, 128, 3), dtype=np.float32)
    with torch.no_grad():
        model(_t(x))                      # the forms cached before the step
    tr = Trainer(model, TrainConfig(total_iters=1, batch_size=2,
                                    crop_size=128, base_lr=1e-2),
                 work_dir=tmp_path, device="cpu")
    tr.fit(iter([(x, x * 0.5)]))
    fresh = build_model("restormer_tiny", device="cpu", seed=3)
    fresh.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(model(_t(x)), fresh(_t(x)), rtol=0,
                                   atol=0)
    blk = model.encoder_level1[0]
    assert blk.fused(torch.zeros(2, 16, 128, 8))
    mw, gw = blk.kernel_weights(_t(x))
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_weights, mdta_weights)
    torch.testing.assert_close(
        mw.w_qkv, mdta_weights(*blk.mdta_params(), blk.attn.num_heads,
                               torch.float32).w_qkv, rtol=0, atol=0)
    torch.testing.assert_close(
        gw.w_out, gdfn_weights(*blk.gdfn_params(), torch.float32).w_out,
        rtol=0, atol=0)
    conv = model.patch_embed.proj
    torch.testing.assert_close(conv.kernel_weights(_t(x)).hwio,
                               conv.hwio().detach(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# classifier training


def test_classifier_streams_are_bit_equal_to_jax():
    """Same seed, same degraded images and labels: the single and the
    multi-degradation synthesizers (with and without ``relabel``), the two
    streams (labels equal, inputs after the MATLAB resize within 1e-5) and
    ``build_dataset`` with the Pillow resize (bit-equal) and without."""
    corpus = tcls.procedural_corpus(3, size=64, seed=2, p_flat=0.34)
    jcorpus = jcls.procedural_corpus(3, size=64, seed=2, p_flat=0.34)
    for a, b in zip(corpus, jcorpus):
        np.testing.assert_array_equal(a, b)
    for fn in ("synthesize_example", "synthesize_multi"):
        for relabel in (False, True):
            ra, rb = np.random.default_rng(4), np.random.default_rng(4)
            for img in corpus * 3:
                (lq, y), (jlq, jy) = (getattr(tcls, fn)(img, ra, relabel=relabel),
                                      getattr(jcls, fn)(img, rb, relabel=relabel))
                np.testing.assert_array_equal(lq, jlq)
                np.testing.assert_array_equal(y, jy)
    for fn in ("example_stream", "multi_example_stream"):
        (x, y), (jx, jy) = (next(getattr(tcls, fn)(corpus, 3, 1, 32,
                                                  device="cpu")),
                            next(getattr(jcls, fn)(jcorpus, 3, 1, 32)))
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(x, np.asarray(jx), atol=1e-5)
    for fast in (True, False):
        xs, ys = tcls.build_dataset(corpus, 6, seed=3, size=32,
                                    fast_resize=fast, relabel=True,
                                    device="cpu")
        jx, jy = jcls.build_dataset(jcorpus, 6, seed=3, size=32,
                                    fast_resize=fast, relabel=True)
        np.testing.assert_array_equal(ys, jy)
        if fast:
            np.testing.assert_array_equal(xs, jx)
        else:
            np.testing.assert_allclose(xs, jx, atol=1e-5)


@pytest.mark.parametrize("recipe", ["v1", "v3", "v4_ordinal", "v5_coral"])
def test_classifier_step_loss_and_gradients_match_jax(recipe):
    """One step of each recipe's loss on the same batch and weights (the
    JAX tree carried by ``convert.from_jax``): the loss within 1e-5
    relative and every gradient within 1e-4 x its largest magnitude (the
    priors' quantiles and the trunk's GroupNorms sum in other orders) plus
    1e-6 x the model's largest gradient, which holds the leaves whose
    gradient is zero but for rounding (a conv bias in front of a
    GroupNorm of one channel a group)."""
    from image_restoration_agent_tpu.iqa import classifier as jiqa
    from image_restoration_agent_tpu_torch.iqa import classifier as tiqa

    rng = np.random.default_rng(5)
    x = rng.random((3, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 5, (3, 8))
    jcls_, tcls_ = {"v1": (jiqa.DegradationClassifier,
                           tiqa.DegradationClassifier),
                    "v5_coral": (jiqa.DegradationClassifierV5,
                                 tiqa.DegradationClassifierV5)}.get(
        recipe, (jiqa.DegradationClassifierV3, tiqa.DegradationClassifierV3))
    jm = jcls_(width=8)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    smooth = 0.2 if recipe == "v4_ordinal" else 0.0
    coral = recipe == "v5_coral"
    nlev = 5

    def jloss(p):  # train_classifier_v3_dataset's loss_fn
        if coral:
            cum = jm.apply(p, jnp.asarray(x), cumulative=True)
            tgt = (jnp.asarray(y)[..., None] > jnp.arange(nlev - 1)
                   ).astype(jnp.float32)
            return optax.sigmoid_binary_cross_entropy(cum, tgt).mean()
        flat = jm.apply(p, jnp.asarray(x)).reshape(-1, nlev)
        if smooth:
            tbl = jnp.asarray(tcls.ordinal_targets(smooth), jnp.float32)
            return optax.softmax_cross_entropy(
                flat, tbl[jnp.asarray(y).reshape(-1)]).mean()
        return optax.softmax_cross_entropy_with_integer_labels(
            flat, jnp.asarray(y).reshape(-1)).mean()

    lj, gj = jax.value_and_grad(jloss)(params)
    tm = tcls_(width=8)
    tm.load_state_dict(from_jax(params), strict=True)
    lt = tcls.classifier_loss(tm, _t(x), _t(y), ordinal_smooth=smooth,
                              coral=coral)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(lt, list(named.values()))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    want = from_jax(gj)
    top = max(float(want[n].abs().max()) for n in named)
    for (name, _), g in zip(named.items(), grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top,
                                   err_msg=name)


def test_classifier_trainers_run_and_learn():
    """The v1 and v3 recipes on a tiny corpus: finite losses, v1's falling
    over 30 steps (the JAX test's recipe); the evaluators' accuracies in
    [0, 1]."""
    hq = _hq(0, size=64)
    from image_restoration_agent_tpu_torch.iqa.classifier import (
        DegradationClassifier, DegradationClassifierV3)

    sd, losses = tcls.train_classifier(hq, steps=30, batch=4, size=64,
                                       model=DegradationClassifier(width=8),
                                       device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    acc = tcls.evaluate_classifier(sd, hq, n=8, size=64,
                                   model=DegradationClassifier(width=8),
                                   device="cpu")
    assert 0.0 <= acc["dominant_acc"] <= 1.0
    corpus = tcls.procedural_corpus(4, size=96, seed=0)
    sd3, losses3 = tcls.train_classifier_v3(
        corpus, steps=4, batch=4, size=64,
        model=DegradationClassifierV3(width=8), device="cpu")
    assert np.isfinite(losses3).all()
    res = tcls.evaluate_multi(sd3, corpus, n=4, size=64,
                              model=DegradationClassifierV3(width=8),
                              device="cpu")
    assert all(0.0 <= v <= 1.0 for v in res.values())


@pytest.mark.parametrize("device_data", [False, True])
@pytest.mark.parametrize("variant", ["ordinal", "coral"])
def test_dataset_trainer_snapshots_and_device_data(variant, device_data):
    """The dataset trainer calls ``snapshot_fn(state_dict, step)`` on its
    cadence (both feeds), finite losses, one per step; the v4 recipe
    (``ordinal_smooth``) and v5 (``coral``)."""
    from image_restoration_agent_tpu_torch.iqa.classifier import (
        DegradationClassifierV3, DegradationClassifierV5)

    rng = np.random.default_rng(0)
    xs = rng.random((8, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 5, (8, 8))
    snaps = []
    model = DegradationClassifierV5(width=8) if variant == "coral" \
        else DegradationClassifierV3(width=8)
    sd, losses = tcls.train_classifier_v3_dataset(
        xs, ys, steps=5, batch=4, model=model, snapshot_every=2,
        snapshot_fn=lambda s, step: snaps.append((step, sorted(s))),
        ordinal_smooth=0.2 if variant == "ordinal" else 0.0,
        coral=variant == "coral", device_data=device_data,
        log_every=2 if device_data else 0, device="cpu")
    assert [s for s, _ in snaps] == [2, 4]
    assert snaps[0][1] == sorted(model.state_dict())
    assert len(losses) == 5 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# retrieval training


def test_info_nce_loss_matches_jax():
    """Symmetric InfoNCE within 1e-6 relative; aligned views score lower
    than shuffled ones."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((5, 16)).astype(np.float32)
    b = rng.standard_normal((5, 16)).astype(np.float32)
    want = float(jret.info_nce_loss(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(float(tret.info_nce_loss(_t(a), _t(b))),
                               want, rtol=1e-6)
    e = torch.eye(4)
    assert tret.info_nce_loss(e, e) < tret.info_nce_loss(
        e, torch.roll(e, 1, 0))


def test_retrieval_training_runs_and_learns():
    """The stand-in (feature 640, its default init from seed 0) trained on
    pairs of noisy views of 4 images for 8 steps at the default lr: finite
    losses, the mean of the last three below the first."""
    rng = np.random.default_rng(7)
    base = rng.random((4, 224, 224, 3)).astype(np.float32)

    def pairs():
        while True:
            noise = rng.normal(0, 0.02, base.shape).astype(np.float32)
            yield base, np.clip(base + noise, 0, 1)

    sd, losses = tret.train_retrieval_model(pairs(), steps=8, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert "caption_embedding" in sd


# ---------------------------------------------------------------------------
# Engine.profile under a failing body


def test_engine_profile_writes_a_trace_when_the_body_raises(tmp_path):
    """The trace is exported in a ``finally``: a body that raises still
    leaves one trace file, and the exception propagates."""
    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(device="cpu")
    img = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
    with pytest.raises(RuntimeError, match="request failed"):
        with eng.profile(tmp_path / "prof"):
            eng.restore_array(img, "nafnet_small")
            raise RuntimeError("request failed")
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert traces == [eng.last_trace]
    events = json.loads(eng.last_trace.read_text())["traceEvents"]
    assert any("conv" in str(ev.get("name", "")) for ev in events)
