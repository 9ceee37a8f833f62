"""The port's command line (``python -m image_restoration_agent_tpu_torch
.cli``) on the CPU: the JAX CLI's subcommands and flags plus ``--device``;
``restore``, ``infer --fast``, ``test-tools``, ``warmup`` and
``insert-runs`` run; the subcommands whose modules are not ported fail
with a message naming them and never import JAX; and every module of the
port, ``cli.py`` and ``api/*`` included, imports in a subprocess where
``jax``, ``flax``, ``optax``, ``orbax``, ``regex``, ``PIL`` and the JAX
package cannot be imported."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_restoration_agent_tpu import cli as jcli
from image_restoration_agent_tpu_torch import cli
from image_restoration_agent_tpu_torch.core import io as tio

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# a meta-path finder refusing JAX, Flax and the JAX package by name
_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "regex", "PIL",
                                  "image_restoration_agent_tpu"):
            raise ImportError("blocked in this test: " + name)
        return None
sys.meta_path.insert(0, _Block())
"""


def _run_blocked(code: str, timeout: int = 240):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _subcommands(parser) -> dict:
    """{subcommand: its option strings and positional names}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {opt for act in p._actions for opt in act.option_strings}
            | {act.dest for act in p._actions if not act.option_strings}
            for name, p in sub.choices.items()}


def test_subcommands_and_flags_are_the_jax_clis_plus_device():
    """Every subcommand of the JAX CLI, each with the JAX CLI's flags; the
    seven that build an engine, an evaluator or an embedder add
    ``--device``."""
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jcli.main(["infer", "x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    want = _subcommands(captured["parser"])
    got = _subcommands(cli.build_parser())
    assert set(got) == set(want)
    with_device = {"infer", "serve", "eval-service", "restore", "test-tools",
                   "warmup", "insert-runs"}
    for name in want:
        extra = {"--device"} if name in with_device else set()
        assert got[name] == want[name] | extra, name
    for name in with_device:
        args = cli.build_parser().parse_args(
            [name] + {"infer": ["x"], "restore": ["x", "--model", "m"],
                      "insert-runs": ["x"]}.get(name, []))
        assert args.device == "cuda"  # nothing picks the CPU by itself


def test_restore_ridcp_on_the_cpu(tmp_path, capsys):
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    img = np.random.default_rng(0).random((72, 100, 3), dtype=np.float32)
    tio.save_image(img, src)
    assert cli.main(["restore", str(src), "--model", "ridcp_tiny", "-o",
                     str(out), "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["shape"] == [72, 100] and rec["output"] == str(out)
    assert tio.load_image(out).shape == (72, 100, 3)


def test_infer_fast_on_the_cpu(tmp_path, capsys):
    src = tmp_path / "in.png"
    tio.save_image(np.random.default_rng(1).random((32, 32, 3),
                                                   dtype=np.float32), src)
    assert cli.main(["infer", str(src), "-o", str(tmp_path / "out"),
                     "--fast", "--no-rollback", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["result"].endswith("result.png")
    assert Path(rec["result"]).exists()


def test_test_tools_on_the_cpu(tmp_path, capsys):
    assert cli.main(["test-tools", "--work-dir", str(tmp_path / "tt"),
                     "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report) >= 8
    assert all(v["ok"] for v in report.values()), report


def test_warmup_on_the_cpu(capsys):
    """On the CPU no kernel is built (they run on the card only); the
    engine walks each (model, size) through the serving path."""
    assert cli.main(["warmup", "--models", "nafnet_small,ridcp_tiny",
                     "--sizes", "32,48x40", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["kernels_built"] is None
    assert len(rec["records"]) == 4
    assert rec["cache_dir"].endswith("csrc/build")
    assert cli.parse_sizes("256,512x768,720p") == jcli.parse_sizes(
        "256,512x768,720p")


def test_insert_runs_on_the_cpu(tmp_path, capsys):
    """``insert-runs --device cpu`` over fabricated agent work dirs writes
    a store the JAX package's ``NumpyVectorStore.load`` reads, under the
    random stand-in's own identity; a second pass adds to it."""
    from image_restoration_agent_tpu.retrieval import (NumpyVectorStore,
                                                       RetrievalEmbedder)
    from test_torch_retrieval import fabricate_runs

    fabricate_runs(tmp_path / "runs")
    store = tmp_path / "store.npz"
    argv = ["insert-runs", str(tmp_path / "runs"), "--store", str(store),
            "--device", "cpu"]
    assert cli.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"inserted": 3, "total": 3, "store": str(store)}
    st = NumpyVectorStore.load(store)
    assert st.embedder_id == "random_standin_torch_seed0"
    assert st._names == ["run_a", "run_b", "run_c"]
    assert st._seqs[0] == "denoising_nafnet/deraining_mprnet"
    np.testing.assert_allclose(np.linalg.norm(st._embs, axis=1), 1.0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="random_standin_torch_seed0"):
        NumpyVectorStore.load(store, embedder=RetrievalEmbedder)
    assert cli.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["inserted"], rec["total"]) == (3, 3)


@pytest.mark.parametrize("cmd", sorted(cli.NOT_PORTED))
def test_unported_subcommands_fail_with_their_module(cmd):
    """Run as ``python -m ...cli`` with JAX blocked: status 2, the missing
    module named on stderr, no traceback (JAX is never reached)."""
    argv = {"score": ["r", "g"], "convert-weights": ["list"],
            "validate-weights": ["--synthetic"], "ablation-grid": [],
            "eval-suite": []}[cmd]
    r = _run_blocked(
        "import runpy, sys\n"
        f"sys.argv = ['cli', {cmd!r}, *{argv!r}]\n"
        "runpy.run_module('image_restoration_agent_tpu_torch.cli', "
        "run_name='__main__')\n")
    assert r.returncode == 2, r.stderr
    assert "not ported yet" in r.stderr
    assert cli.NOT_PORTED[cmd].split()[0] in r.stderr
    assert "Traceback" not in r.stderr


def test_every_port_module_imports_without_jax():
    """Every module of image_restoration_agent_tpu_torch (cli.py, api/*,
    retrieval/* and iqa/* included) imports where jax, flax, optax, orbax,
    regex, PIL and image_restoration_agent_tpu cannot be imported."""
    r = _run_blocked(
        "import importlib, pkgutil\n"
        "import image_restoration_agent_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'regex', 'PIL', "
        "'image_restoration_agent_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names), ' '.join(names))\n")
    assert r.returncode == 0, r.stderr
    count, names = r.stdout.split(" ", 1)
    for mod in ("cli", "api.server", "api.eval_service", "api.playground",
                "api.controller", "core.io_native", "core.decode_pool",
                "core.color", "utils.config", "utils.misc", "ops.dcn",
                "models.ridcp", "retrieval.store", "retrieval.combiner",
                "retrieval.tokenizer", "retrieval.clip",
                "retrieval.embedder", "train.retrieval", "iqa.metrics",
                "iqa.lpips", "iqa.vit", "iqa.maniqa", "iqa.musiq",
                "iqa.clipiqa", "iqa.scorer"):
        assert f"image_restoration_agent_tpu_torch.{mod}" in names.split()
    assert int(count) > 60
