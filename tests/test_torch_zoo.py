"""The zoo behind the agent's default toolboxes: the port's registry
against the JAX package's (the new models' serving specs field for field,
the same names in both), the default toolboxes it resolves, and a whole
agent run of image_restoration_agent_tpu_torch against the JAX agent on a
toolbox of the new tiny models with the same weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.agent import executor as jexec
from image_restoration_agent_tpu.models import MODEL_REGISTRY as JREG
from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu_torch.agent import executor as texec
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.models import MODEL_REGISTRY as TREG
from test_torch_xrestormer import randomize

torch.set_num_threads(1)

NEW = ("xrestormer", "xrestormer_tiny", "mprnet", "mprnet_tiny", "maxim_s2",
       "maxim_s3", "maxim_tiny", "drbnet", "drbnet_tiny", "ifan",
       "ifan_tiny", "diffbir", "diffbir_tiny")


def _fields(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if f.name != "build"}


@pytest.mark.parametrize("name", NEW)
def test_spec_equals_jax(name):
    """Subtasks, scale, pad multiple, mode and kind, tile and overlap,
    whole-image pad, config: the JAX package's, field for field."""
    assert _fields(TREG[name]) == _fields(JREG[name])


def test_only_diffbir_and_ridcp_are_missing():
    """Since DiffBIR landed, nothing is missing: the two registries hold
    the same 35 names."""
    assert set(JREG) == set(TREG) and len(TREG) == 35


@pytest.mark.parametrize("subtask", [
    "denoising", "motion deblurring", "deraining", "defocus deblurring",
    "jpeg compression artifact removal", "dehazing", "super-resolution"])
def test_default_toolbox_resolves(subtask):
    """Every model of each box of the unmodified DEFAULT_TOOLBOXES is
    registered, the super-resolution box's ``diffbir`` included, and the
    port's table is the JAX package's."""
    assert all(m in TREG for _, m in texec.DEFAULT_TOOLBOXES[subtask])
    assert texec.DEFAULT_TOOLBOXES[subtask] == \
        jexec.DEFAULT_TOOLBOXES[subtask]


# ---------------------------------------------------------------------------
# a whole agent run on the new tiny models

_TOOLBOXES = {
    "super-resolution": [("xrestormer", "xrestormer_tiny")],
    "denoising": [("xrestormer", "xrestormer_tiny"),
                  ("mprnet", "mprnet_tiny"), ("maxim", "maxim_tiny")],
    "motion deblurring": [("mprnet", "mprnet_tiny"),
                          ("maxim", "maxim_tiny")],
    "defocus deblurring": [("drbnet", "drbnet_tiny"), ("ifan", "ifan_tiny")],
    "dehazing": [("maxim", "maxim_tiny")],
    "deraining": [("xrestormer", "xrestormer_tiny"),
                  ("mprnet", "mprnet_tiny")],
    "jpeg compression artifact removal": [("drbnet", "drbnet_tiny")],
}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """(JAX engine, port engine, input png) with the same random tiny
    weights: orbax checkpoints for the JAX engine, the same tensors carried
    across by from_jax as .npz for the port's."""
    from image_restoration_agent_tpu.convert.torch_import import save_as_orbax
    from image_restoration_agent_tpu.engine import Engine as JEngine
    from image_restoration_agent_tpu_torch.convert import from_jax
    from image_restoration_agent_tpu_torch.engine import Engine

    root = tmp_path_factory.mktemp("zoo")
    (root / "port").mkdir()
    names = sorted({m for box in _TOOLBOXES.values() for _, m in box})
    for seed, name in enumerate(names):
        m = jbuild(name)
        params = randomize(jax.eval_shape(lambda m=m: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), seed)
        # scale MPRNet's and MAXIM's weights down so their residual stacks
        # keep the output near the image's range
        if name in ("mprnet_tiny", "maxim_tiny"):
            params = jax.tree.map(lambda a: 0.5 * a, params)
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


def test_iragent_on_new_models_matches_jax(zoo, tmp_path):
    """IRAgent without rollback, rng_seed 0, on the same input: the port's
    plan, execution path and tool invocations equal the JAX agent's."""
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
                          with_rollback=False, silent=True, **kw)
        assert agent.run().exists()
        s = json.loads(agent.summary_path.read_text())
        runs.append({k: s[k] for k in ("plan", "execution_path",
                                       "n_invocations")})
    assert runs[0]["plan"]["initial"], runs[0]
    assert runs[0]["n_invocations"] >= 3, runs[0]
    assert runs[1] == runs[0]
