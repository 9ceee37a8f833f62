"""Multi-rank dry run: what ``__graft_entry__.dryrun_multichip`` does for
the JAX package, on process groups.

``dryrun_multichip(n)`` runs, on ``n`` ranks:

- one sharded train step of ``nafnet_small`` (width 8) on a ``data x
  model`` mesh (data 2 where ``n`` is even), whose loss must be finite;
- tile-parallel inference of a 48x48 image (``tiled_apply_sharded``) and
  the halo-exchange variant (``tiled_apply_halo``), each against the
  single-process ``core.tiling.tiled_apply`` within the JAX module's
  few-ulp bound (1e-5), and the same for ``restormer_tiny``;
- ``swinir_tiny`` x4 through both tile-parallel paths (the window and x4
  halo constraints);
- a host-aware global mesh.

Where the world is already initialized with ``n`` ranks, the body runs in
this process (on the card under ``nccl``). Otherwise ``n`` ranks are
spawned: ``nccl`` ranks on ``n`` cards where that many are present, else
``gloo`` ranks on the CPU. Every spawned process is stopped before the call
returns, and a rank that fails or outlives ``timeout`` seconds fails it.

    python -m image_restoration_agent_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(a: torch.Tensor, b: torch.Tensor, atol: float, what: str) -> float:
    err = float((a.float() - b.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs difference {err} > {atol}")
    return err


def dryrun_body(n: int, device: str | torch.device) -> dict:
    """The dry run on a world of ``n`` initialized ranks (see the module
    docstring); returns this rank's record."""
    from ..core.tiling import plan_tiles, tiled_apply
    from ..models import build_model
    from .halo_tiling import halo_pad_height, tiled_apply_halo
    from .mesh import make_global_mesh, make_mesh
    from .tile_parallel import tiled_apply_sharded
    from .train_step import (UpdateRule, make_sharded_train_step,
                             make_train_state)

    dev = torch.device(device)
    dp = 2 if n % 2 == 0 and n >= 2 else 1
    mp = n // dp

    # training: dp over the batch, the weights sharded over model
    mesh = make_mesh({"data": dp, "model": mp})
    model = build_model("nafnet_small", device=dev, width=8,
                        enc_blk_nums=(1,), dec_blk_nums=(1,))
    tx = UpdateRule(1e-3)
    batch = max(dp * 2, 2)
    lq = torch.full((batch, 16, 16, 3), 0.25, device=dev)
    hq = torch.full((batch, 16, 16, 3), 0.5, device=dev)
    step, shard_state, shard_batch = make_sharded_train_step(model, tx,
                                                             mesh)
    state = shard_state(make_train_state(model, tx))
    state, loss = step(state, shard_batch(lq), shard_batch(hq))
    loss = float(loss)
    assert np.isfinite(loss), "train step produced a non-finite loss"

    def image(seed, h, w):
        return torch.from_numpy(np.random.default_rng(seed).random(
            (h, w, 3), dtype=np.float32)).to(dev)

    tile_mesh = make_mesh({"tile": n})
    errs = {}
    with torch.no_grad():
        # tile parallelism (the domain's sequence parallelism)
        img = image(1, 48, 48)
        out = tiled_apply_sharded(model, img, tile_mesh, tile=16,
                                  overlap=4, pad_multiple=8)
        single = tiled_apply(model, img, tile=16, overlap=4, pad_multiple=8)
        errs["nafnet_sharded"] = _close(out, single, 1e-5, "sharded NAFNet")
        hp = halo_pad_height(48, 16, 12, n)
        img2 = image(2, hp, 48)
        out2 = tiled_apply_halo(model, img2, tile_mesh, tile=16, overlap=4)
        assert out2.shape == (hp, 48, 3), out2.shape
        errs["nafnet_halo"] = _close(out2, tiled_apply(
            model, img2, tile=16, overlap=4,
            batch=len(plan_tiles(hp, 48, 16, 4).w_starts)), 1e-5,
            "halo NAFNet")

        # SwinIR x4: window multiples and x4 output halos
        swin = build_model("swinir_tiny", device=dev, seed=1)
        simg = image(3, 32, 32)
        sout = tiled_apply_sharded(swin, simg, tile_mesh, tile=16,
                                   overlap=8, scale=4, pad_multiple=8)
        assert sout.shape == (128, 128, 3), sout.shape
        shp = halo_pad_height(32, 16, 8, n)
        sout2 = tiled_apply_halo(swin, image(4, shp, 32), tile_mesh,
                                 tile=16, overlap=8, scale=4)
        assert sout2.shape == (shp * 4, 128, 3), sout2.shape

        # Restormer's MDTA under sharding, within the few-ulp bound
        rest = build_model("restormer_tiny", device=dev, seed=2)
        rimg = image(5, 32, 32)
        errs["restormer_sharded"] = _close(
            tiled_apply_sharded(rest, rimg, tile_mesh, tile=16, overlap=4,
                                pad_multiple=8),
            tiled_apply(rest, rimg, tile=16, overlap=4, pad_multiple=8),
            1e-5, "sharded Restormer")

    gm = make_global_mesh({"tile": max(n // 2, 1)}, dcn_axis="data")
    assert set(gm.shape) == {"data", "tile"}
    return {"rank": dist.get_rank() if dist.is_initialized() else 0,
            "mesh": {"data": dp, "model": mp}, "loss": loss,
            "tile_parallel": list(out.shape), "halo": list(out2.shape),
            "swinir_x4": list(sout.shape), "swinir_halo": list(sout2.shape),
            "global_mesh": gm.shape, "max_abs_err": errs}


def _worker(rank: int, n: int, port: int, backend: str) -> None:
    from .mesh import init_distributed

    torch.set_num_threads(1)
    dev = init_distributed(f"127.0.0.1:{port}", n, rank, backend=backend)
    rec = dryrun_body(n, dev)
    dist.barrier()
    dist.destroy_process_group()
    print("DRYRUN " + json.dumps(rec), flush=True)


def spawn(n: int, code: str, timeout: float) -> list[str]:
    """Run ``code`` (Python, with ``RANK`` and ``WORLD`` and ``PORT`` set
    as globals) in ``n`` processes from the repo root; return each rank's
    stdout. Raises if a rank fails or the ranks outlive ``timeout``; every
    process is stopped before it returns."""
    port = free_port()
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(_ROOT)] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"RANK, WORLD, PORT = {r}, {n}, {port}\n{code}"],
        cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{n} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n"
                           + "\n".join(o[-3000:] for o in outs))
    return outs


def dryrun_multichip(n: int, timeout: float = 600.0) -> dict:
    """The dry run over ``n`` ranks (module docstring); returns rank 0's
    record."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                             f"not {n}")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        return dryrun_body(n, dev)
    backend = "nccl" if torch.cuda.is_available() \
        and torch.cuda.device_count() >= n else "gloo"
    outs = spawn(n, "from image_restoration_agent_tpu_torch.parallel.dryrun "
                    f"import _worker\n_worker(RANK, WORLD, PORT, "
                    f"{backend!r})", timeout)
    recs = [json.loads(ln[len("DRYRUN "):]) for o in outs
            for ln in o.splitlines() if ln.startswith("DRYRUN ")]
    if len(recs) != n:
        raise RuntimeError("ranks finished without a record:\n" + outs[0])
    return {**recs[0], "backend": backend, "ranks": n}


if __name__ == "__main__":
    print(json.dumps(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                                      else 4)))
