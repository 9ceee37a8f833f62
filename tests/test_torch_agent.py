"""Port parity for the agent chain: the pure-Python parts (MockLLM,
``_loose_json``, StateGraph, ImgTree, prompts, the executor's tool
contract) against the JAX package's, and whole agent runs (IRAgent with
and without rollback, the graph app) of image_restoration_agent_tpu_torch
against the JAX agent on the same tiny weights, the same input and the same
v4 classifier. The slow tier reproduces the pinned agent golden trace on
the port's CPU path."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.agent import executor as jexec
from image_restoration_agent_tpu.agent import graph as jgraph
from image_restoration_agent_tpu.agent import img_tree as jtree
from image_restoration_agent_tpu.agent import llm as jllm
from image_restoration_agent_tpu.agent import prompts as jprompts
from image_restoration_agent_tpu.core import io as jio
from image_restoration_agent_tpu_torch.agent import executor as texec
from image_restoration_agent_tpu_torch.agent import graph as tgraph
from image_restoration_agent_tpu_torch.agent import img_tree as ttree
from image_restoration_agent_tpu_torch.agent import llm as tllm
from image_restoration_agent_tpu_torch.agent import prompts as tprompts
from image_restoration_agent_tpu_torch.core import io as tio

torch.set_num_threads(1)

TRACE_PATH = Path(__file__).parent / "data" / "agent_golden_trace.json"


# ---------------------------------------------------------------------------
# pure Python against the JAX package


def _graphs(mod):
    linear = mod.StateGraph()
    linear.add_node("a", lambda s: {"x": s.get("x", 0) + 1})
    linear.add_node("b", lambda s: {"x": s["x"] * 10})
    linear.set_entry_point("a")
    linear.add_edge("a", "b")
    linear.add_edge("b", mod.END)
    loop = mod.StateGraph()
    loop.add_node("tick", lambda s: {"n": s.get("n", 0) + 1})
    loop.set_entry_point("tick")
    loop.add_conditional_edges(
        "tick", lambda s: "more" if s["n"] < 5 else "done",
        {"more": "tick", "done": mod.END})
    return linear.compile().invoke({}), loop.compile().invoke({})


def test_state_graph_matches_jax():
    assert _graphs(tgraph) == _graphs(jgraph) == ({"x": 10}, {"n": 5})
    assert tgraph.END == jgraph.END


def test_state_graph_runaway_guard_and_validation():
    g = tgraph.StateGraph()
    g.add_node("loop", lambda s: s)
    g.set_entry_point("loop")
    g.add_conditional_edges("loop", lambda s: "go", {"go": "loop"})
    with pytest.raises(RuntimeError):
        g.compile().invoke({}, max_steps=10)
    g2 = tgraph.StateGraph()
    g2.add_node("a", lambda s: s)
    g2.add_edge("a", "nowhere")
    g2.set_entry_point("a")
    with pytest.raises(ValueError):
        g2.compile()
    with pytest.raises(ValueError):
        g2.add_node("a", lambda s: s)


_PROMPTS = [
    'tasks: [\'super-resolution\', \'denoising\'] ... "order" must be a '
    "permutation of ['super-resolution', 'denoising']",
    tprompts.SCHEDULE_WITH_EXPERIENCE.format(
        degradations=["noise", "haze", "dark"],
        agenda=["denoising", "dehazing", "brightening"], experience="x")
    + tprompts.RESCHEDULE_POSTSCRIPT.format(failed_tries="dehazing"),
    tprompts.SCHEDULE_WITHOUT_EXPERIENCE.format(
        degradations=["rain", "jpeg compression artifact"],
        agenda=["deraining", "jpeg compression artifact removal"],
        insights="ok"),
    tprompts.EVALUATE_TOOL_RESULT.format(degradation="noise"),
    tprompts.COMPARE_QUALITY,
    tprompts.DISTILL_KNOWLEDGE.format(experience="e"),
    "hello",
]


@pytest.mark.parametrize("i", range(len(_PROMPTS)))
def test_mock_llm_answers_as_jax(i):
    a, b = tllm.MockLLM(), jllm.MockLLM()
    assert a(_PROMPTS[i]) == b(_PROMPTS[i])
    assert a.calls == b.calls == [_PROMPTS[i]]


def test_mock_llm_format_check_and_canonical_order():
    llm = tllm.MockLLM()
    ans = llm(_PROMPTS[0], format_check=lambda o: (
        isinstance(o, dict) and set(o) == {"thought", "order"}) or None)
    assert tllm._loose_json(ans)["order"] == ["denoising",
                                              "super-resolution"]
    assert tllm.MockLLM.CANONICAL_ORDER == jllm.MockLLM.CANONICAL_ORDER


@pytest.mark.parametrize("text", [
    '```json\n{"a": [1, 2]}\n```', "Sure: {'a': 'b', 'c': [1]}",
    '["x", "y"]', ' noise {"severity": "low", "thought": "t"} '])
def test_loose_json_matches_jax(text):
    assert tllm._loose_json(text) == jllm._loose_json(text)


def test_prompts_are_the_jax_packages():
    names = [n for n in dir(jprompts) if n.isupper()]
    assert names and all(getattr(tprompts, n) == getattr(jprompts, n)
                         for n in names)


def test_img_tree_matches_jax(tmp_path):
    root = tmp_path / "img_tree"
    leaf = root / "subtask-denoising" / "tool-nafnet" / "subtask-dehazing" \
        / "tool-dehazeformer" / "0-img"
    rng = np.random.default_rng(3)
    for d in (root / "0-img", leaf.parents[2] / "0-img", leaf):
        tio.save_image(rng.random((8, 8, 3), dtype=np.float32),
                       d / "x.png")
    img = leaf / "x.png"
    want = jtree.ImgTree(root, tmp_path / "j").get_execution_path(img)
    got = ttree.ImgTree(root, tmp_path / "t").get_execution_path(img)
    assert got == want == [("denoising", "nafnet"),
                           ("dehazing", "dehazeformer")]
    assert ttree.ImgTree(root, tmp_path / "t").to_html().read_text() == \
        jtree.ImgTree(root, tmp_path / "j").to_html().read_text()


@pytest.fixture(scope="module")
def fast_executor():
    return texec.build_default_executor(fast=True, device="cpu")


def test_executor_tables_match_jax(fast_executor):
    assert texec.SUBTASKS == jexec.SUBTASKS
    assert texec.DEFAULT_TOOLBOXES == jexec.DEFAULT_TOOLBOXES
    for subtask, tools in fast_executor.toolbox_router.items():
        assert tools, subtask


@pytest.mark.parametrize("tool", ["gamma_correction", "constant_shift",
                                  "histogram_equalization"])
def test_tool_contract_matches_jax(fast_executor, tmp_path, tool):
    """The reference directory contract (one image in, ``output.png``
    out) on the port; the brightening tools give the JAX package's
    pixels."""
    in_dir = tmp_path / "0-img"
    img = np.random.default_rng(4).random((32, 40, 3), dtype=np.float32)
    tio.save_image(0.3 * img, in_dir / "input.png")
    out = fast_executor.invoke_a_tool("brightening", tool, in_dir,
                                      tmp_path / "t")
    assert out.name == "output.png" and out.exists()
    want = jexec.build_default_executor(engine=object(), fast=True) \
        .invoke_a_tool("brightening", tool, in_dir, tmp_path / "j")
    np.testing.assert_array_equal(tio.load_image(out),
                                  jio.load_image(want))
    if tool == "constant_shift":
        assert tio.load_image(out).mean() > 0.3 * 255 * 0.5 + 20


def test_unserved_toolbox_model_raises_at_first_call(tmp_path):
    """A toolbox entry whose model the port does not register builds (the
    executor resolves models at call time) and raises ``KeyError`` when it
    is called."""
    from image_restoration_agent_tpu_torch.engine import Engine
    ex = texec.build_default_executor(
        engine=Engine(device="cpu"),
        toolboxes={"super-resolution": [("ghost", "no_such_model")]})
    in_dir = tmp_path / "0-img"
    tio.save_image(np.zeros((8, 8, 3), np.float32), in_dir / "input.png")
    with pytest.raises(KeyError):
        ex.invoke_a_tool("super-resolution", "ghost", in_dir,
                         tmp_path / "o")


# ---------------------------------------------------------------------------
# whole agents against the JAX agent on shared tiny weights

# every subtask a tool of one of the two tiny models (the super-resolution
# box too, as x1: the 192 px input puts super-resolution on the agenda)
_TOOLBOXES = {
    "super-resolution": [("nafnet", "nafnet_small")],
    "denoising": [("nafnet", "nafnet_small"), ("fbcnn", "fbcnn_tiny")],
    "motion deblurring": [("nafnet", "nafnet_small")],
    "defocus deblurring": [("nafnet", "nafnet_small")],
    "dehazing": [("fbcnn", "fbcnn_tiny")],
    "deraining": [("nafnet", "nafnet_small")],
    "jpeg compression artifact removal": [("fbcnn", "fbcnn_tiny")],
}


def _randomize(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(a):
        n = rng.standard_normal(a.shape).astype(np.float32)
        if len(a.shape) <= 1:
            return 0.05 * n
        return (0.5 * n / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """(JAX engine, port engine, input png) with the same tiny weights: the
    JAX engine restores orbax checkpoints, the port's engine reads the
    same tensors carried across as .npz."""
    from image_restoration_agent_tpu.convert.torch_import import save_as_orbax
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu.models import build_model as jbuild
    from image_restoration_agent_tpu_torch.convert import from_jax
    from image_restoration_agent_tpu_torch.engine import Engine

    root = tmp_path_factory.mktemp("zoo")
    (root / "port").mkdir()
    for seed, name in enumerate(("nafnet_small", "fbcnn_tiny")):
        m = jbuild(name)
        params = _randomize(jax.eval_shape(lambda m=m: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), seed)
        save_as_orbax(params, root / "jax" / name)
        np.savez(root / "port" / f"{name}.npz",
                 **{k: v.numpy() for k, v in from_jax(params).items()})
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:192, 0:192] / 192.0
    clean = np.stack([yy, xx, 0.5 + 0.5 * np.sin(6 * yy * xx)], -1)
    noisy = np.clip(clean + rng.normal(0.0, 25.0 / 255.0, clean.shape),
                    0.0, 1.0).astype(np.float32)
    inp = root / "case" / "noisy.png"
    tio.save_image(noisy, inp)
    return (JEngine(weight_dir=root / "jax", allow_random_init=False),
            Engine(weight_dir=root / "port", device="cpu",
                   allow_random_init=False), inp)


def _trace(summary: dict) -> dict:
    return {"plan": summary["plan"],
            "execution_path": summary["execution_path"],
            "n_invocations": summary["n_invocations"]}


@pytest.mark.parametrize("rollback", [False, True],
                         ids=["no-rollback", "rollback"])
def test_iragent_matches_jax_agent(zoo, tmp_path, rollback):
    from image_restoration_agent_tpu.agent import IRAgent as JAgent
    from image_restoration_agent_tpu_torch.agent import IRAgent
    jeng, teng, inp = zoo
    runs = []
    for agent_cls, ex, out in (
            (JAgent, jexec.build_default_executor(
                engine=jeng, toolboxes=_TOOLBOXES), "j"),
            (IRAgent, texec.build_default_executor(
                engine=teng, toolboxes=_TOOLBOXES), "t")):
        kw = {} if agent_cls is JAgent else {"device": "cpu"}
        agent = agent_cls(inp, tmp_path / out, executor=ex, rng_seed=0,
                          with_rollback=rollback, silent=True, **kw)
        assert agent.run().exists()
        runs.append(_trace(json.loads(agent.summary_path.read_text())))
    assert runs[0]["plan"]["initial"], runs[0]
    assert runs[1] == runs[0]


def test_graph_app_matches_jax(zoo, tmp_path):
    from image_restoration_agent_tpu.agent import run_agent as jrun
    from image_restoration_agent_tpu_torch.agent import run_agent
    jeng, teng, inp = zoo
    want = jrun(inp, tmp_path / "j", executor=jexec.build_default_executor(
        engine=jeng, toolboxes=_TOOLBOXES))
    got = run_agent(inp, tmp_path / "t", executor=texec
                    .build_default_executor(engine=teng,
                                            toolboxes=_TOOLBOXES),
                    device="cpu")
    keys = ("initial_plan", "executed", "subtask_success", "evaluation")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert Path(got["output_path"]).exists()


# ---------------------------------------------------------------------------
# the pinned agent golden trace, on the port's CPU path


@pytest.mark.slow
def test_agent_golden_trace_on_the_port(tmp_path):
    """The recipe of tests/test_agent_goldens.py on the port: nafnet_synth
    and fbcnn_synth weights (no random init), the nafnet golden input
    edge-padded by 64 plus seeded noise, rng_seed 0, no rollback; the plan
    and execution trace equal tests/data/agent_golden_trace.json."""
    from image_restoration_agent_tpu_torch.agent import IRAgent
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import (
        GOLDEN_ROOT, materialize_synthetic_weights)

    torch.set_num_threads(4)
    wroot = tmp_path / "weights"
    mats = materialize_synthetic_weights(
        wroot, names=["nafnet_synth", "fbcnn_synth"])
    assert {"nafnet", "fbcnn_blind"} <= set(mats), mats
    engine = Engine(weight_dir=wroot, device="cpu", allow_random_init=False)
    toolboxes = {
        "denoising": [("nafnet", "nafnet")],
        "motion deblurring": [("nafnet", "nafnet")],
        "defocus deblurring": [("nafnet", "nafnet")],
        "deraining": [("nafnet", "nafnet")],
        "dehazing": [("nafnet", "nafnet")],
        "super-resolution": [],
        "jpeg compression artifact removal":
            [("fbcnn_blind", "fbcnn_blind")],
    }
    ex = texec.build_default_executor(engine=engine, toolboxes=toolboxes)
    clean = tio.to_float(tio.load_image(
        GOLDEN_ROOT / "nafnet_synth" / "input.png"))
    clean = np.pad(clean, ((0, 64), (0, 64), (0, 0)), mode="edge")
    rng = np.random.default_rng(42)
    noisy = np.clip(clean + rng.normal(0.0, 25.0 / 255.0, clean.shape),
                    0.0, 1.0).astype(np.float32)
    inp = tmp_path / "case" / "noisy.png"
    tio.save_image(noisy, inp)
    agent = IRAgent(inp, tmp_path / "out", executor=ex, rng_seed=0,
                    with_rollback=False, silent=True, device="cpu")
    assert agent.run().exists()
    s = json.loads(agent.summary_path.read_text())
    trace = {"plan_initial": s["plan"]["initial"],
             "execution_subtasks": s["execution_path"]["subtasks"],
             "execution_tools": s["execution_path"]["tools"],
             "n_invocations": s["n_invocations"]}
    assert trace == json.loads(TRACE_PATH.read_text())
