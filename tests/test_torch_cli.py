"""The port's command line (``python -m image_restoration_agent_tpu_torch
.cli``) on the CPU: the JAX CLI's subcommands and flags plus ``--device``;
``restore``, ``infer --fast``, ``test-tools``, ``warmup`` and
``insert-runs`` run; ``score``, ``convert-weights``, ``validate-weights``,
``ablation-grid`` and ``eval-suite`` run in a subprocess where JAX cannot
be imported and print the JAX CLI's JSON keys; and every module of the
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
    eleven that build an engine, a scorer, an evaluator or an embedder add
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
                   "warmup", "insert-runs", "score", "validate-weights",
                   "ablation-grid", "eval-suite"}
    for name in want:
        extra = {"--device"} if name in with_device else set()
        assert got[name] == want[name] | extra, name
    for name in with_device:
        args = cli.build_parser().parse_args(
            [name] + {"infer": ["x"], "restore": ["x", "--model", "m"],
                      "insert-runs": ["x"], "score": ["r", "g"]}.get(name,
                                                                    []))
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


# a tiny manifest entry (injected as tests/test_validate_weights.py does):
# swinir_tiny's own reference-named state, saved in SwinIR's wrapper
_TINY_ENTRY = """
import torch
from image_restoration_agent_tpu_torch.convert import manifest
from image_restoration_agent_tpu_torch.models import build_model
torch.save({"params": build_model("swinir_tiny", device="cpu")
            .state_dict()}, WORK + "/ckpts/tiny_swinir.pth")
manifest.MANIFEST = (
    manifest.WeightEntry("swinir_tiny", "tiny_swinir.pth", "local",
                         "swinir_rules"),
    manifest.WeightEntry("swinir_sr_x4", "absent.pth", "local",
                         "swinir_rules"))
"""

# subcommand case -> (argv after the subcommand, setup code, JSON keys the
# JAX CLI prints)
_CASES = {
    "score": (["{w}/res", "{w}/gt", "-o", "{w}/s.json"], "",
              {"mean", "n"}),
    "convert-weights": (["nafnet"], "",
                        {"model", "ckpt_file", "source", "rules", "notes"}),
    "convert-weights-ckpt": (["swinir_tiny", "--ckpt",
                              "{w}/ckpts/tiny_swinir.pth", "--out",
                              "{w}/conv"], _TINY_ENTRY, {"weights_file"}),
    "validate-weights": (["{w}/ckpts", "--out", "{w}/weights"], _TINY_ENTRY,
                         {"pass", "converted_aux", "failed", "missing"}),
    "validate-weights-synthetic": (["--synthetic", "--models",
                                    "nafnet_synth"], "",
                                   {"records", "pass", "failed"}),
    "ablation-grid": (["--combos", "1", "--work-dir", "{w}/grid"], "",
                      {"variants", "pairs", "report"}),
    "eval-suite": (["--combos", "2", "--work-dir", "{w}/suite"], "",
                   {"mean_input_psnr", "mean_output_psnr", "cases",
                    "report"}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_offline_subcommands_run_on_the_cpu(case, tmp_path):
    """Run as ``python -m ...cli <subcommand> ... --device cpu`` (no
    ``--device`` for ``convert-weights``, which builds nothing) with JAX
    blocked: exit 0, the JAX CLI's JSON keys on the last line, JAX never
    reached."""
    cmd = case.split("-ckpt")[0].split("-synthetic")[0]
    argv, setup, keys = _CASES[case]
    argv = [a.format(w=tmp_path) for a in argv]
    if cmd != "convert-weights":
        argv += ["--device", "cpu"]
    (tmp_path / "ckpts").mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.random((16, 20, 3), dtype=np.float32)
        tio.save_image(img, tmp_path / "gt" / f"{i}.png")
        tio.save_image(np.clip(img + 0.05, 0, 1), tmp_path / "res" / f"{i}.png")
    r = _run_blocked(
        "import runpy, sys, torch\n"
        "torch.set_num_threads(2)\n"
        f"WORK = {str(tmp_path)!r}\n" + setup
        + f"sys.argv = ['cli', {cmd!r}, *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('image_restoration_agent_tpu_torch.cli', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'image_restoration_agent_tpu')]\n"
        "assert not bad, bad\n")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "blocked in this test" not in r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == keys, out
    if case == "score":
        assert out["n"] == 2 and out["mean"]["psnr"] > 20
    elif case == "convert-weights-ckpt":
        assert out["weights_file"].endswith("conv/swinir_tiny.npz")
    elif case == "validate-weights":
        assert (out["pass"], out["missing"], out["failed"]) == (1, 1, 0)
    elif case == "validate-weights-synthetic":
        assert (out["pass"], out["failed"]) == (1, 0)
    elif case == "ablation-grid":
        assert len(out["variants"]) == 6 and len(out["pairs"]) == 7
    elif case == "eval-suite":
        assert out["cases"] == 2
        assert (tmp_path / "suite" / "report.json").exists()


@pytest.mark.parametrize("argv", [["score", "r", "g"], ["eval-suite"],
                                  ["ablation-grid"],
                                  ["validate-weights", "--synthetic"]])
def test_offline_subcommands_default_to_the_card(argv, tmp_path,
                                                 monkeypatch):
    """Without ``--device`` they run on ``cuda``: without a card they
    raise before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)


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
                "iqa.clipiqa", "iqa.scorer", "data.degrade",
                "offline.benchmark_suite", "offline.eval_harness",
                "offline.exploration", "offline.distill",
                "offline.validate_weights", "convert.manifest",
                "convert.torch_import", "convert.maxim_rules"):
        assert f"image_restoration_agent_tpu_torch.{mod}" in names.split()
    assert int(count) > 60
