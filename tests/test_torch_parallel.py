"""Multi-rank parity for the port's parallel slice on ``gloo`` (CPU): the
process-group mesh, tile-parallel and halo-exchange inference against
``core.tiling.tiled_apply``, the ``data x model`` sharded train step
against the single-process step, a two-host global mesh, and the dry run.
The JAX package's ``tests/test_parallel.py``, ``test_halo_tiling.py`` and
``test_multihost.py`` check the same on its virtual device mesh. Each
spawn of 2 or 4 ranks has its own time limit of 60 s."""

import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.parallel.halo_tiling import \
    halo_pad_height as jhalo_pad_height
from image_restoration_agent_tpu.parallel.train_step import \
    param_sharding_rule as jrule
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.parallel import (
    UpdateRule, halo_pad_height, make_mesh, make_sharded_train_step,
    make_train_state)
from image_restoration_agent_tpu_torch.parallel.dryrun import (
    dryrun_multichip, spawn)

torch.set_num_threads(1)
TIMEOUT = 60

_PRELUDE = """
import json, os
import numpy as np, torch
torch.set_num_threads(1)
from image_restoration_agent_tpu_torch.parallel.mesh import init_distributed
init_distributed(f"127.0.0.1:{PORT}", WORLD, RANK, backend="gloo")
def emit(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def _ranks(n: int, body: str) -> list[dict]:
    """Run ``body`` on ``n`` gloo ranks; each rank's ``emit``ted record."""
    outs = spawn(n, _PRELUDE + textwrap.dedent(body), TIMEOUT)
    recs = [json.loads(ln[len("RESULT "):]) for o in outs
            for ln in o.splitlines() if ln.startswith("RESULT ")]
    assert len(recs) == n, outs
    return sorted(recs, key=lambda r: r["rank"])


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_without_a_world():
    """One process: axes of size 1 make a mesh with no groups; more ranks
    than the world has raise, as JAX raises on too few devices."""
    mesh = make_mesh({"data": 1, "model": 1})
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"tile": 2})


def test_mesh_shapes_groups_and_too_few_ranks():
    """On 4 ranks: ``{"data": 2, "tile": 2}`` lays ranks out row-major;
    an all-reduce over ``tile``, over ``data`` and over both sums the
    right ranks; a mesh of 1024 ranks raises; ``local_mesh`` spans the
    host."""
    recs = _ranks(4, """
        from image_restoration_agent_tpu_torch.parallel.mesh import (
            local_mesh, make_mesh)
        mesh = make_mesh({"data": 2, "tile": 2})
        v = lambda: torch.tensor([float(RANK)])
        try:
            make_mesh({"tile": 1024})
            raised = False
        except ValueError:
            raised = True
        emit({"rank": RANK, "shape": mesh.shape, "coords": mesh.coords,
              "tile": mesh.all_reduce(v(), "tile").item(),
              "data": mesh.all_reduce(v(), "data").item(),
              "both": mesh.all_reduce(v(), ("data", "tile")).item(),
              "gather": [t.item() for t in mesh.all_gather(v(), "tile")],
              "raised": raised, "local": local_mesh().shape})
    """)
    for r, rec in enumerate(recs):
        assert rec["shape"] == {"data": 2, "tile": 2}
        assert tuple(rec["coords"]) == (r // 2, r % 2)
        assert rec["tile"] == (r // 2) * 4 + 1          # r and its pair
        assert rec["data"] == 2 + 2 * (r % 2)           # r % 2 and + 2
        assert rec["both"] == 6
        assert rec["gather"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert rec["raised"] and rec["local"] == {"tile": 4}


def test_two_host_global_mesh_all_reduce():
    """2 hosts x 2 ranks (``LOCAL_WORLD_SIZE`` 2): the host boundary is the
    outer ``data`` axis (row p of the mesh is host p's ranks); a global
    sum over both axes of a (4, 8) array split by rows, and a data-parallel
    mean across hosts, as the JAX two-process test computes."""
    recs = _ranks(4, """
        os.environ["LOCAL_WORLD_SIZE"] = "2"
        from image_restoration_agent_tpu_torch.parallel.mesh import (
            make_global_mesh)
        mesh = make_global_mesh({"tile": 2}, dcn_axis="data")
        full = np.arange(32, dtype=np.float32).reshape(4, 8)
        total = torch.tensor(full[RANK].sum())
        mesh.all_reduce(total, ("data", "tile"))
        mine = torch.tensor([float(mesh.index("data"))])
        mesh.all_reduce(mine, "data")
        emit({"rank": RANK, "shape": mesh.shape,
              "ranks": mesh.ranks.tolist(), "total": total.item(),
              "data_mean": mine.item() / mesh.shape["data"]})
    """)
    for rec in recs:
        assert rec["shape"] == {"data": 2, "tile": 2}
        assert rec["ranks"] == [[0, 1], [2, 3]]
        assert rec["total"] == float(np.arange(32).sum())
        assert rec["data_mean"] == 0.5


# ---------------------------------------------------------------------------
# tile-parallel and halo-exchange inference


def test_halo_pad_height_matches_jax():
    """Copied whole: equal to the JAX function over a grid, and its
    constraints hold."""
    for h in (1, 17, 48, 100, 150, 200, 257):
        for tile, stride in ((16, 12), (32, 24), (32, 8), (64, 48)):
            for n in (1, 2, 3, 4, 8):
                hp = halo_pad_height(h, tile, stride, n)
                assert hp == jhalo_pad_height(h, tile, stride, n)
                assert hp >= h and (hp - tile) % stride == 0
                assert ((hp - tile) // stride + 1) % n == 0


_TILING = """
    from image_restoration_agent_tpu_torch.core.tiling import (plan_tiles,
                                                               tiled_apply)
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.parallel import (
        halo_pad_height, make_mesh, tiled_apply_halo, tiled_apply_sharded)
    mesh = make_mesh({"tile": WORLD})
    rng = np.random.default_rng(0)
    def img(h, w):
        return torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    half = lambda b: b * 0.5 + 0.25
    up2 = lambda b: b.repeat_interleave(2, 1).repeat_interleave(2, 2)
    out = {"rank": RANK}
    # the JAX tests' cases: 96x80 (tile 32, overlap 8), 72x72 at x2 with a
    # tile count that does not divide by the ranks
    a = img(96, 80)
    out["sharded"] = bool(torch.equal(
        tiled_apply_sharded(half, a, mesh, tile=32, overlap=8,
                            pad_multiple=8),
        tiled_apply(half, a, tile=32, overlap=8, batch=64, pad_multiple=8)))
    b = img(72, 72)
    n = plan_tiles(72, 72, 32, 8).num_tiles
    got = tiled_apply_sharded(up2, b, mesh, tile=32, overlap=8, scale=2,
                              pad_multiple=8)
    out["ragged"] = n % WORLD != 0
    out["sharded_x2"] = bool(torch.equal(got, tiled_apply(
        up2, b, tile=32, overlap=8, scale=2, batch=64, pad_multiple=8)))
    out["sharded_x2_exact"] = bool(torch.equal(got, up2(b[None])[0]))
    for name, fn, s, h, w in (("halo", half, 1, 150, 80),
                              ("halo_x2", up2, 2, 120, 72)):
        c = img(halo_pad_height(h, 32, 24, WORLD), w)
        out[name] = bool(torch.equal(
            tiled_apply_halo(fn, c, mesh, tile=32, overlap=8, scale=s),
            tiled_apply(fn, c, tile=32, overlap=8, scale=s, batch=64,
                        pad_multiple=1)))
    # a model: halo calls it once per tile row, as tiled_apply with that
    # batch does (bit-equal); the sharded shares are other batch shapes
    m = build_model("nafnet_small", device="cpu", width=8,
                    enc_blk_nums=(1,), dec_blk_nums=(1,))
    with torch.no_grad():
        d = img(halo_pad_height(40, 16, 12, WORLD), 48)
        cols = len(plan_tiles(d.shape[0], 48, 16, 4).w_starts)
        out["halo_model"] = bool(torch.equal(
            tiled_apply_halo(m, d, mesh, tile=16, overlap=4),
            tiled_apply(m, d, tile=16, overlap=4, batch=cols,
                        pad_multiple=1)))
        e = img(48, 48)
        out["sharded_model_err"] = float((tiled_apply_sharded(
            m, e, mesh, tile=16, overlap=4, pad_multiple=8) - tiled_apply(
            m, e, tile=16, overlap=4, pad_multiple=8)).abs().max())
    emit(out)
"""


@pytest.mark.parametrize("n", [2, 4])
def test_tile_parallel_and_halo_match_single_process(n):
    """Both tile-parallel paths on ``n`` ranks: with elementwise functions
    (x1, and x2 with a tile count the ranks do not divide) bit-equal to
    ``tiled_apply``, the blend being the same by construction; the halo
    path with a NAFNet forward bit-equal too (one batch per tile row, as
    ``tiled_apply`` with that batch); the sharded path with NAFNet within
    1e-5 (its shares are other batch shapes: the JAX module's few-ulp
    contract)."""
    recs = _ranks(n, _TILING)
    for rec in recs:
        assert rec["sharded"] and rec["sharded_x2"]
        assert rec["sharded_x2_exact"] and rec["halo"] and rec["halo_x2"]
        assert rec["halo_model"]
        assert rec["sharded_model_err"] <= 1e-5
    assert recs[0]["ragged"]  # 9 tiles over 2 or 4 ranks


# ---------------------------------------------------------------------------
# the sharded train step


NAF = dict(width=8, enc_blk_nums=(1,), dec_blk_nums=(1,))


def _jax_shard_dims() -> dict:
    """Each port parameter's shard dim on a model axis of 2, as the JAX
    ``param_sharding_rule`` picks it on the JAX leaf: a marker varying
    along the chosen JAX dim, carried through ``from_jax``'s relayout,
    varies along the port's dim."""
    jm = jbuild("nafnet_small", **NAF)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    np.zeros((1, 16, 16, 3), np.float32)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))

    def marker(leaf):
        spec = jrule(None, leaf, mesh).spec
        dims = [i for i, a in enumerate(spec) if a == "model"]
        if not dims:
            return np.zeros(leaf.shape, np.float32)
        d = dims[0]
        shape = [1] * leaf.ndim
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(1, leaf.shape[d] + 1, dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    out = {}
    for name, t in from_jax(jax.tree.map(marker, params)).items():
        varying = [i for i in range(t.ndim) if t.shape[i] > 1 and not
                   torch.equal(t.narrow(i, 0, 1).expand_as(t), t)]
        assert len(varying) <= 1, name
        out[name] = varying[0] if varying else None
    return out


def test_sharded_train_step_matches_single_process(tmp_path):
    """``data=2 x model=2`` on 4 ranks, two steps on a batch of 4 (each
    data rank 2): the losses within 1e-6 relative of the single-process
    step on the whole batch, the parameters gathered into the model within
    1e-6 + 1e-5 x |p| of its (float32 rounding of the batch mean taken in
    halves); each rank holds half of every shardable parameter and of its
    two Adam moments on the dim JAX's ``param_sharding_rule`` picks, and
    the rest whole."""
    path = tmp_path / "rank0.pth"
    recs = _ranks(4, f"""
        from image_restoration_agent_tpu_torch.models import build_model
        from image_restoration_agent_tpu_torch.parallel import (
            UpdateRule, make_mesh, make_sharded_train_step,
            make_train_state)
        rng = np.random.default_rng(7)
        lq = torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
        hq = torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
        model = build_model("nafnet_small", device="cpu", **{NAF!r})
        tx = UpdateRule(1e-3)
        mesh = make_mesh({{"data": 2, "model": 2}})
        step, shard_state, shard_batch = make_sharded_train_step(
            model, tx, mesh)
        state = shard_state(make_train_state(model, tx))
        losses = []
        for _ in range(2):
            state, loss = step(state, shard_batch(lq), shard_batch(hq))
            losses.append(loss.item())
        if RANK == 0:
            torch.save({{"losses": losses, "state": model.state_dict()}},
                       {str(path)!r})
        emit({{"rank": RANK, "losses": losses,
              "shapes": {{n: list(p.shape) for n, p in
                          state.params.items()}},
              "mu": [list(m.shape) for m in state.opt_state.mu],
              "nu": [list(v.shape) for v in state.opt_state.nu],
              "count": state.opt_state.count, "step": state.step}})
    """)
    rng = np.random.default_rng(7)
    lq = torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
    hq = torch.from_numpy(rng.random((4, 16, 16, 3), dtype=np.float32))
    model = build_model("nafnet_small", device="cpu", **NAF)
    tx = UpdateRule(1e-3)
    step, _, _ = make_sharded_train_step(model, tx, make_mesh(
        {"data": 1, "model": 1}))
    state = make_train_state(model, tx)
    losses = []
    for _ in range(2):
        state, loss = step(state, lq, hq)
        losses.append(loss.item())
    got = torch.load(path, weights_only=True)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(got["state"][name], p, rtol=1e-5,
                                   atol=1e-6, msg=name)

    dims = _jax_shard_dims()
    full = dict(model.named_parameters())
    assert sorted(dims) == sorted(full)
    names = list(full)
    n_sharded = 0
    for rec in recs:
        assert rec["count"] == rec["step"] == 2
        for i, name in enumerate(names):
            want = list(full[name].shape)
            if dims[name] is not None:
                want[dims[name]] //= 2
                n_sharded += 1
            assert rec["shapes"][name] == want, name
            assert rec["mu"][i] == rec["nu"][i] == want, name
    assert n_sharded > 0


def test_single_process_mesh_step_is_the_trainer_step(tmp_path):
    """The Trainer's step is the sharded step on a 1 x 1 mesh: the same
    losses and parameters, bit for bit, as the step built by hand."""
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)

    rng = np.random.default_rng(8)
    lq = rng.random((2, 16, 16, 3), dtype=np.float32)
    hq = rng.random((2, 16, 16, 3), dtype=np.float32)
    a = build_model("nafnet_small", device="cpu", **NAF)
    tr = Trainer(a, TrainConfig(total_iters=2, base_lr=1e-3, log_freq=1),
                 work_dir=tmp_path, device="cpu")
    tr.fit(iter([(lq, hq)] * 2))
    b = build_model("nafnet_small", device="cpu", **NAF)
    tx = UpdateRule(1e-3)
    step, _, _ = make_sharded_train_step(b, tx, make_mesh({"data": 1,
                                                           "model": 1}))
    state = make_train_state(b, tx)
    for i in range(2):
        state, loss = step(state, torch.from_numpy(lq), torch.from_numpy(hq))
        assert tr.history[i]["loss"] == loss.item()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_sharded_swinir_step_is_the_trainer_step(tmp_path):
    """The Swin kernels' backward on two ``gloo`` ranks: ``swinir_tiny``
    (x4 head, 16 px LR) on a ``data=1 x model=2`` mesh, each rank holding
    half of every shardable parameter and gathering the whole ones back
    into the model after each update (so every Swin block's kernel form is
    remade from the written parameters), two steps: the losses and the
    gathered parameters equal the ``Trainer``'s step on one process within
    float32 rounding (1e-6 relative on the losses, 1e-5 x |p| + 1e-6)."""
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)

    path = tmp_path / "rank0.pth"
    _ranks(2, f"""
        from image_restoration_agent_tpu_torch.models import build_model
        from image_restoration_agent_tpu_torch.parallel import (
            UpdateRule, make_mesh, make_sharded_train_step,
            make_train_state)
        rng = np.random.default_rng(9)
        lq = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
        hq = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
        model = build_model("swinir_tiny", device="cpu", seed=4)
        tx = UpdateRule(1e-3)
        step, shard_state, shard_batch = make_sharded_train_step(
            model, tx, make_mesh({{"data": 1, "model": 2}}))
        state = shard_state(make_train_state(model, tx))
        losses = []
        for _ in range(2):
            state, loss = step(state, shard_batch(lq), shard_batch(hq))
            losses.append(loss.item())
        if RANK == 0:
            torch.save({{"losses": losses, "state": model.state_dict()}},
                       {str(path)!r})
        emit({{"rank": RANK, "losses": losses}})
    """)
    rng = np.random.default_rng(9)
    lq = rng.random((2, 16, 16, 3), dtype=np.float32)
    hq = rng.random((2, 64, 64, 3), dtype=np.float32)
    model = build_model("swinir_tiny", device="cpu", seed=4)
    tr = Trainer(model, TrainConfig(total_iters=2, base_lr=1e-3, log_freq=1),
                 work_dir=tmp_path / "single", device="cpu")
    tr.fit(iter([(lq, hq)] * 2))
    got = torch.load(path, weights_only=True)
    np.testing.assert_allclose(got["losses"],
                               [h["loss"] for h in tr.history], rtol=1e-6)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(got["state"][name], p, rtol=1e-5,
                                   atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# the dry run


def test_dryrun_multichip_on_four_ranks():
    """``parallel.dryrun.dryrun_multichip(4)``, what
    ``__graft_entry__.dryrun_multichip`` does for JAX: 4 gloo ranks, one
    ``data=2 x model=2`` train step with a finite loss, tile-parallel and
    halo inference (NAFNet, SwinIR x4, Restormer) within the few-ulp bound
    of the single-process path."""
    rec = dryrun_multichip(4, timeout=TIMEOUT)
    assert rec["backend"] == "gloo" and rec["ranks"] == 4
    assert rec["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(rec["loss"])
    assert rec["tile_parallel"] == [48, 48, 3]
    assert rec["swinir_x4"] == [128, 128, 3]
    assert all(v <= 1e-5 for v in rec["max_abs_err"].values())
