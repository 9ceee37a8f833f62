"""The port's offline pipelines (``image_restoration_agent_tpu_torch
.offline``) against the JAX package's on the CPU: the 16-combo suite and
the ablation grid on shared tiny weights (the ``zoo`` fixture of
``test_torch_agent.py``), batch scoring, the exploration tree and its fail
rates, distillation, and ``Engine.profile``."""

import json

import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.agent import executor as jexec
from image_restoration_agent_tpu.core import io as jio
from image_restoration_agent_tpu.offline import benchmark_suite as jsuite
from image_restoration_agent_tpu.offline import eval_harness as jharness
from image_restoration_agent_tpu.offline import exploration as jexplore
from image_restoration_agent_tpu_torch.agent import executor as texec
from image_restoration_agent_tpu_torch.offline import (
    benchmark_suite as tsuite)
from image_restoration_agent_tpu_torch.offline import (
    eval_harness as tharness)
from image_restoration_agent_tpu_torch.offline import (
    exploration as texplore)
from test_torch_agent import _TOOLBOXES, zoo  # noqa: F401 (fixture)

torch.set_num_threads(1)

COMBOS = ["dark + noise", "defocus blur + jpeg compression artifact"]
VARIANTS = {"default": {}, "worb": {"with_rollback": False}}


def _executors(zoo):  # noqa: F811
    jeng, teng, _ = zoo
    return (jexec.build_default_executor(engine=jeng, toolboxes=_TOOLBOXES),
            texec.build_default_executor(engine=teng, toolboxes=_TOOLBOXES))


def _assert_records_match(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["combo"] == w["combo"]
        for k in ("plan", "executed", "n_invocations"):
            assert g[k] == w[k], (k, g, w)
        for k in ("input_psnr", "output_psnr"):
            assert abs(g[k] - w[k]) <= 0.05, (k, g, w)
        for k in ("input_ssim", "output_ssim"):
            assert abs(g[k] - w[k]) <= 1e-3, (k, g, w)


def test_tables_are_the_jax_packages():
    assert tharness.ABLATION_VARIANTS == jharness.ABLATION_VARIANTS
    assert tharness.ABLATION_PAIRS == jharness.ABLATION_PAIRS


def test_run_suite_matches_jax(zoo, tmp_path):  # noqa: F811
    jex, tex = _executors(zoo)
    want = jsuite.run_suite(tmp_path / "j", combos=COMBOS, executor=jex)
    got = tsuite.run_suite(tmp_path / "t", combos=COMBOS, executor=tex,
                           device="cpu")
    assert want["records"][0]["plan"], want
    _assert_records_match(got["records"], want["records"])
    for k in ("mean_input_psnr", "mean_output_psnr"):
        assert abs(got[k] - want[k]) <= 0.05
    on_disk = json.loads((tmp_path / "t" / "report.json").read_text())
    assert on_disk == got
    # given equal records the table is the JAX package's, byte for byte
    assert tsuite.render_table(want["records"]) == \
        jsuite.render_table(want["records"])
    assert (tmp_path / "t" / "report.md").read_text() == \
        tsuite.render_table(got["records"])
    for case in ("case_001", "case_002"):
        np.testing.assert_array_equal(
            jio.load_image(tmp_path / "t" / case / "hq.png"),
            jio.load_image(tmp_path / "j" / case / "hq.png"))


def test_ablation_grid_matches_jax(zoo, tmp_path):  # noqa: F811
    jex, tex = _executors(zoo)
    want = jharness.run_ablation_grid(tmp_path / "j", combos=COMBOS[:1],
                                      executor=jex, variants=VARIANTS)
    got = tharness.run_ablation_grid(tmp_path / "t", combos=COMBOS[:1],
                                     executor=tex, variants=VARIANTS,
                                     device="cpu")
    assert set(got["variants"]) == set(want["variants"]) == set(VARIANTS)
    for name in VARIANTS:
        for k, v in want["variants"][name].items():
            assert abs(got["variants"][name][k] - v) <= 0.05
    assert [(p["dim"], p["with"], p["without"], p["n"])
            for p in got["pairs"]] == [(p["dim"], p["with"], p["without"],
                                        p["n"]) for p in want["pairs"]]
    assert json.loads((tmp_path / "t" / "ablation_grid.json")
                      .read_text()) == got


def test_grid_markdown_is_the_jax_packages(tmp_path, monkeypatch):
    """Given equal suite reports, the grid's markdown and JSON are the JAX
    package's, byte for byte."""
    def fake_suite(work_dir, agent_kwargs=None, **kw):
        shift = len(agent_kwargs or {})
        recs = [{"combo": c, "input_psnr": 12.0 + i,
                 "output_psnr": 14.25 + i - shift, "input_ssim": 0.4,
                 "output_ssim": 0.5 + 0.01 * shift, "plan": ["denoising"],
                 "executed": ["denoising"], "n_invocations": 1}
                for i, c in enumerate(COMBOS)]
        return {"records": recs, "mean_input_psnr": 12.5,
                "mean_output_psnr": 14.75 - shift}

    monkeypatch.setattr(jsuite, "run_suite", fake_suite)
    monkeypatch.setattr(tsuite, "run_suite", fake_suite)
    grids = [mod.run_ablation_grid(tmp_path / name, executor=object(),
                                   **kw)
             for name, mod, kw in (("j", jharness, {}),
                                   ("t", tharness, {"device": "cpu"}))]
    assert grids[0] == grids[1]
    assert len(grids[1]["pairs"]) == 7
    for f in ("ablation_grid.md", "ablation_grid.json"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()


def test_compute_scores_and_compare_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.random((24, 20, 3), dtype=np.float32)
        jio.save_image(img, tmp_path / "gt" / f"{i}.png")
        jio.save_image(np.clip(img + 0.02 * i, 0, 1),
                       tmp_path / "a" / f"{i}.png")
        jio.save_image(np.clip(img + 0.1, 0, 1), tmp_path / "b" / f"{i}.png")
    scores = {}
    for m in ("a", "b"):
        want = jharness.compute_scores(tmp_path / m, tmp_path / "gt")
        got = tharness.compute_scores(tmp_path / m, tmp_path / "gt",
                                      tmp_path / f"{m}.json", device="cpu")
        assert got["n"] == want["n"] == 3
        assert set(got["per_image"]) == set(want["per_image"])
        for name, s in want["per_image"].items():
            for k, v in s.items():
                np.testing.assert_allclose(got["per_image"][name][k], v,
                                           rtol=1e-6)
        for k, v in want["mean"].items():
            np.testing.assert_allclose(got["mean"][k], v, rtol=1e-6)
        assert json.loads((tmp_path / f"{m}.json").read_text()) == got
        scores[m] = want
    assert tharness.compare_methods(scores) == \
        jharness.compare_methods(scores)
    assert "a beats b on 3/3 images" in tharness.compare_methods(scores)


@pytest.mark.parametrize("counts", [[2, 3], [3], [3, 6], [1, 2, 3]])
def test_expected_tree_counts_match_jax(counts):
    assert texplore.expected_tree_counts(counts) == \
        jexplore.expected_tree_counts(counts)


def test_exploration_tree_and_fail_rates_match_jax(zoo, tmp_path):  # noqa: F811,E501
    """One subtask (denoising: NAFNet and FBCNN on the shared tiny
    weights): the same tree, and the same fail rates from each package's
    classifier."""
    from image_restoration_agent_tpu.agent.evaluators import (
        LocalEvaluator as JEval)
    from image_restoration_agent_tpu_torch.agent.evaluators import (
        LocalEvaluator)

    jex, tex = _executors(zoo)
    src = tmp_path / "in.png"
    jio.save_image(np.random.default_rng(3).random((40, 48, 3),
                                                   dtype=np.float32), src)
    subtasks = ["denoising"]
    jl = jexplore.exhaust_sequences(src, tmp_path / "j", subtasks, jex)
    tl = texplore.exhaust_sequences(src, tmp_path / "t", subtasks, tex)
    rel = [{p.relative_to(tmp_path / s) for p in (tmp_path / s).rglob("*")}
           for s in ("j", "t")]
    assert rel[1] == rel[0]
    assert [p.relative_to(tmp_path / "t") for p in tl] == \
        [p.relative_to(tmp_path / "j") for p in jl]
    counts = texplore.expected_tree_counts(
        [len(tex.toolbox_router[s]) for s in subtasks])
    assert len(tl) == counts["leaves"]
    want = jexplore.explore_fail_rates(tmp_path / "j", JEval(), subtasks)
    got = texplore.explore_fail_rates(tmp_path / "t",
                                      LocalEvaluator(device="cpu"), subtasks)
    assert got == want and got
    texplore.save_fail_rates(got, tmp_path / "fail_rate.json")
    assert json.loads((tmp_path / "fail_rate.json").read_text()) == got


def test_distill_matches_jax(tmp_path):
    from image_restoration_agent_tpu.agent.llm import MockLLM as JMock
    from image_restoration_agent_tpu.offline.distill import (
        distill_experience as jdistill)
    from image_restoration_agent_tpu_torch.agent.llm import MockLLM
    from image_restoration_agent_tpu_torch.offline import distill_experience
    from image_restoration_agent_tpu_torch.offline.distill import (
        render_experience)

    rates = {
        "denoising -> brightening": {
            "n": 180, "fail_rate_total": 0.311,
            "fail_rate[dark]": 0.30, "fail_rate[noise]": 0.322},
        "brightening -> denoising": {
            "n": 180, "fail_rate_total": 0.381,
            "fail_rate[dark]": 0.428, "fail_rate[noise]": 0.333},
    }
    want = jdistill(rates, JMock())
    got = distill_experience(rates, MockLLM(), tmp_path / "exp.json")
    assert got == want and got["distilled"]
    assert render_experience(rates) == want["raw"]
    assert json.loads((tmp_path / "exp.json").read_text()) == got


def test_engine_profile_writes_a_trace(tmp_path):
    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(device="cpu")
    img = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
    with eng.profile(tmp_path / "prof") as e:
        assert e is eng
        eng.restore_array(img, "nafnet_small")
    trace = eng.last_trace
    assert trace is not None and trace.parent == tmp_path / "prof"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(ev.get("name", "")) for ev in events)
