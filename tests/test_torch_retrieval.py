"""Port parity for the retrieval fast path: the vector stores (semantics,
and the ``.npz`` file read and written across the packages), the
stand-in embedder (carried weights and its identities),
``default_embedder``, ``insert_solved_runs`` and ``recall_at_k`` against
the JAX package's ``retrieval/`` and ``train/retrieval.py``; a whole tiny
``IRAgent`` in ``clip_retrieval`` mode and the graph app's two branches
against the JAX agent on shared tiny weights; and the reference fault of
``cli infer --evaluate-by clip_retrieval``, pinned in both packages."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu import cli as jcli
from image_restoration_agent_tpu.agent import executor as jexec
from image_restoration_agent_tpu.retrieval import embedder as jemb
from image_restoration_agent_tpu.retrieval import store as jstore
from image_restoration_agent_tpu.train import retrieval as jtrain
from image_restoration_agent_tpu_torch import cli
from image_restoration_agent_tpu_torch.agent import executor as texec
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.core import io as tio
from image_restoration_agent_tpu_torch.retrieval import embedder as temb
from image_restoration_agent_tpu_torch.retrieval import store as tstore
from image_restoration_agent_tpu_torch.train import retrieval as ttrain

from test_torch_agent import _TOOLBOXES, _trace, zoo  # noqa: F401
from test_torch_clip import random_tree

torch.set_num_threads(1)

DIM = 16  # the stand-in's feature width here (its Combiner keeps 2560/5120)


# ---------------------------------------------------------------------------
# the stores

def _store(mod, embedder=None):
    st = mod.NumpyVectorStore(dim=4, embedder=embedder)
    st.insert(mod.RetrievalRecord("a", "denoising_nafnet",
                                  np.array([1, 0, 0, 0], np.float32)))
    st.insert(mod.RetrievalRecord("b", "brightening_gamma_correction",
                                  np.array([0, 2, 0, 0], np.float32)))
    st.insert(mod.RetrievalRecord("c", "dehazing_ridcp/deraining_mprnet",
                                  np.array([0.6, 0.8, 0.1, 0], np.float32)))
    return st


@pytest.mark.parametrize("q", [[0.9, 0.1, 0, 0], [0, 0, 1, 0], [1, 1, 1, 1],
                               [-1, 0, 0, 0]])
def test_store_queries_match_jax(q):
    q = np.asarray(q, np.float32)
    for topk in (1, 2, 5):
        want = _store(jstore).query(q, topk=topk)
        got = _store(tstore).query(q, topk=topk)
        assert [h["name"] for h in got] == [h["name"] for h in want]
        assert [h["res_seq"] for h in got] == [h["res_seq"] for h in want]
        np.testing.assert_allclose([h["similarity"] for h in got],
                                   [h["similarity"] for h in want],
                                   rtol=1e-6)


def test_store_semantics():
    st = _store(tstore)
    assert len(st) == 3
    st.insert(tstore.RetrievalRecord("a", "dehazing_x",
                                     np.array([0, 0, 3, 0], np.float32)))
    hit = st.query(np.array([0, 0, 1, 0], np.float32), topk=1)[0]
    assert (hit["name"], hit["res_seq"], len(st)) == ("a", "dehazing_x", 3)
    assert hit["similarity"] == pytest.approx(1.0)
    st.insert(tstore.RetrievalRecord("a", "keep_me", np.ones(4, np.float32)),
              on_conflict="ignore")
    assert st.query(np.array([0, 0, 1, 0], np.float32), 1)[0]["res_seq"] \
        == "dehazing_x"
    assert tstore.NumpyVectorStore(dim=4).query(np.ones(4)) == []
    with pytest.raises(ValueError, match="4-d store"):
        st.insert(tstore.RetrievalRecord("d", "x", np.ones(5, np.float32)))
    with pytest.raises(ValueError, match="no embedder"):
        st.embed("x.png")


class _Emb:
    def __init__(self, identity):
        self.identity = identity


@pytest.mark.parametrize("writer,reader", [(jstore, tstore),
                                           (tstore, jstore)],
                         ids=["jax-to-port", "port-to-jax"])
def test_store_file_is_the_same_across_packages(tmp_path, writer, reader):
    """A store written by either package loads in the other, and both
    write the same keys, the same ``meta`` JSON and the same vectors."""
    paths = {}
    for mod in (jstore, tstore):
        st = _store(mod, _Emb("trained_standin"))
        paths[mod] = tmp_path / f"{mod.__name__.split('.')[0]}.npz"
        st.save(paths[mod])
    with np.load(paths[jstore]) as a, np.load(paths[tstore]) as b:
        assert sorted(a.files) == sorted(b.files) == ["embeddings", "meta"]
        assert str(a["meta"]) == str(b["meta"])
        np.testing.assert_array_equal(a["embeddings"], b["embeddings"])
    st = reader.NumpyVectorStore.load(paths[writer],
                                      embedder=_Emb("trained_standin"))
    assert st.embedder_id == "trained_standin" and len(st) == 3
    hits = st.query(np.array([0, 1, 0, 0], np.float32), topk=3)
    assert [h["name"] for h in hits] == ["b", "c", "a"]
    with pytest.raises(ValueError, match="trained_standin"):
        reader.NumpyVectorStore.load(paths[writer],
                                     embedder=_Emb("clip4cir_rn50x4"))
    assert len(reader.NumpyVectorStore.load(
        paths[writer], embedder=_Emb("clip4cir_rn50x4"),
        allow_mismatch=True)) == 3


def test_pg_vector_store_raises_as_jax():
    """Neither machine has psycopg2: both packages refuse the same way."""
    errs = []
    for mod in (jstore, tstore):
        with pytest.raises(RuntimeError) as e:
            mod.PgVectorStore()
        errs.append((str(e.value), type(e.value.__cause__)))
    assert errs[0] == errs[1]
    assert errs[1][1] is ModuleNotFoundError


# ---------------------------------------------------------------------------
# the stand-in embedder, default_embedder

@pytest.fixture(scope="module")
def standin():
    """(JAX params, JAX embedder, port embedder) of the stand-in at width
    16 on shared random weights."""
    m = jemb.RetrievalModel(DIM)
    params = random_tree(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))), 1)
    return (params, jemb.RetrievalEmbedder(params=params, feature_dim=DIM),
            temb.RetrievalEmbedder(state=from_jax(params), feature_dim=DIM,
                                   device="cpu"))


def test_standin_embeddings_match_jax(standin, tmp_path):
    _, je, te = standin
    rng = np.random.default_rng(3)
    for shape in ((60, 60, 3), (192, 256, 3)):
        img = rng.random(shape, dtype=np.float32)
        want, got = je.embed_array(img), te.embed_array(img)
        assert got.shape == want.shape == (DIM,)
        assert float(np.abs(got - want).max()) <= 1e-4
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)
    tio.save_image(img, tmp_path / "x.png")
    assert float(np.abs(te.embed_path(tmp_path / "x.png")
                        - je.embed_path(tmp_path / "x.png")).max()) <= 1e-4


def test_standin_identities(standin, tmp_path):
    """Carried weights keep the JAX identity; a randomly initialised port
    stand-in records its own, so a store of the other package's stand-in
    refuses to load under it."""
    _, je, te = standin
    assert te.identity == je.identity == "trained_standin"
    rnd = temb.RetrievalEmbedder(seed=3, device="cpu")
    assert rnd.identity == "random_standin_torch_seed3"
    assert rnd.model.combiner.combiner_layer.weight.shape == (5120, 5120)
    st = jstore.NumpyVectorStore(dim=DIM, embedder=je)
    st.insert(jstore.RetrievalRecord("a", "denoising_nafnet",
                                     je.embed_array(np.zeros((8, 8, 3)))))
    st.save(tmp_path / "s.npz")
    with pytest.raises(ValueError, match="random_standin_torch_seed3"):
        tstore.NumpyVectorStore.load(tmp_path / "s.npz", embedder=rnd)
    assert len(tstore.NumpyVectorStore.load(tmp_path / "s.npz",
                                            embedder=te)) == 1


def test_default_embedder_picks_by_assets(tmp_path, monkeypatch):
    """The CLIP embedder where all three assets are in the weights
    directory, else the stand-in with random weights."""
    calls = []
    monkeypatch.setattr(temb.CLIPRetrievalEmbedder, "from_npz",
                        classmethod(lambda cls, *a, **kw: calls.append(
                            (a, kw)) or "clip"))
    monkeypatch.setattr(temb, "RetrievalEmbedder",
                        lambda **kw: ("standin", kw))
    assert temb.default_embedder(tmp_path, device="cpu") == \
        ("standin", {"device": "cpu"})
    for name in ("clip_rn50x4.npz", "combiner.npz"):
        (tmp_path / name).write_bytes(b"")
    assert temb.default_embedder(tmp_path, device="cpu")[0] == "standin"
    (tmp_path / "bpe_simple_vocab_16e6.txt.gz").write_bytes(b"")
    assert temb.default_embedder(tmp_path, device="cpu") == "clip"
    assert calls == [((tmp_path / "clip_rn50x4.npz",
                       tmp_path / "combiner.npz",
                       tmp_path / "bpe_simple_vocab_16e6.txt.gz"),
                      {"device": "cpu"})]


# ---------------------------------------------------------------------------
# insert_solved_runs, recall_at_k

def fabricate_runs(root: Path) -> None:
    """Agent work dirs as IRAgent leaves them, plus the cases the walk
    skips: a bad summary, subtasks without their tools, no input image,
    no executed subtask."""
    rng = np.random.default_rng(0)
    runs = {
        "run_a": (["denoising", "deraining"], ["nafnet", "mprnet"], True),
        "run_b": (["dehazing"], ["ridcp"], True),
        "run_c": (["brightening", "super-resolution"],
                  ["gamma_correction", "diffbir"], True),
        "run_mismatch": (["denoising", "dehazing"], ["nafnet"], True),
        "run_no_input": (["denoising"], ["nafnet"], False),
        "run_empty": ([], [], True),
    }
    for name, (subtasks, tools, has_input) in runs.items():
        logs = root / name / "logs"
        logs.mkdir(parents=True)
        (logs / "summary.json").write_text(json.dumps({"execution_path": {
            "subtasks": subtasks, "tools": tools}}))
        if has_input:
            tio.save_image(rng.random((48 + len(name), 40, 3),
                                      dtype=np.float32),
                           root / name / "img_tree" / "0-img" / "input.png")
    (root / "run_bad" / "logs").mkdir(parents=True)
    (root / "run_bad" / "logs" / "summary.json").write_text("{not json")


def test_insert_solved_runs_matches_jax(standin, tmp_path):
    _, je, te = standin
    fabricate_runs(tmp_path / "runs")
    js = jstore.NumpyVectorStore(dim=DIM, embedder=je)
    ts = tstore.NumpyVectorStore(dim=DIM, embedder=te)
    n_j = jtrain.insert_solved_runs(tmp_path / "runs", js, je)
    n_t = ttrain.insert_solved_runs(tmp_path / "runs", ts, te)
    assert n_t == n_j == 3
    assert ts._names == js._names == ["run_a", "run_b", "run_c"]
    assert ts._seqs == js._seqs == [
        "denoising_nafnet/deraining_mprnet", "dehazing_ridcp",
        "brightening_gamma_correction/super-resolution_diffbir"]
    assert float(np.abs(ts._embs - js._embs).max()) <= 1e-4
    # min_steps; a second pass replaces (same names)
    assert ttrain.insert_solved_runs(tmp_path / "runs", ts, te,
                                     min_steps=2) == \
        jtrain.insert_solved_runs(tmp_path / "runs", js, je, min_steps=2) \
        == 2
    assert len(ts) == 3


class _ByMean:
    """A deterministic embedder: per-channel means and their square
    roots."""
    identity = "by_mean"

    def embed_array(self, img):
        m = np.asarray(img, np.float32).mean(axis=(0, 1))
        return np.concatenate([m, np.sqrt(m)])


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(5)
    gallery = [rng.random((8, 8, 3), dtype=np.float32) * s
               for s in (0.2, 0.5, 1.0, 0.7)]
    labels_g = ["dark", "mid", "bright", "mid"]
    queries = [g + 0.01 for g in gallery] + [gallery[0][::-1] * 2.5]
    labels_q = labels_g + ["dark"]
    for ks in ((1, 5), (1, 2, 3)):
        want = jtrain.recall_at_k(_ByMean(), queries, gallery, labels_q,
                                  labels_g, ks)
        got = ttrain.recall_at_k(_ByMean(), queries, gallery, labels_q,
                                 labels_g, ks)
        assert got == want
    assert 0 < got["recall@1"] < 1


# ---------------------------------------------------------------------------
# the agent in clip_retrieval mode and the graph app's branches

def centre(params, images):
    """``params`` of the stand-in with its fused output centred on
    ``images``: the dynamic scalar off (a bias of -30) and the output
    layer's bias less the mean pre-normalisation output. Random weights
    give every pair of images a cosine above 0.9, so without this no
    different image falls under the graph app's 0.9 threshold."""
    p = jax.tree.map(np.array, params)
    c = p["params"]["combiner"]
    c["ds_out"]["bias"][:] = -30.0
    te = temb.RetrievalEmbedder(state=from_jax(p), feature_dim=DIM,
                                device="cpu")
    outs = []
    with torch.no_grad():
        for img in images:
            x = temb.prepare_input(torch.from_numpy(img))[None]
            m = te.model
            f = m.image_tower(x)
            t = m.caption_embedding.expand_as(f)
            cb = m.combiner
            both = torch.cat([torch.relu(cb.text_projection_layer(t)),
                              torch.relu(cb.image_projection_layer(f))], -1)
            s = cb.dynamic_scalar(both)
            out = cb.output_layer(torch.relu(cb.combiner_layer(both))) \
                + s * t + (1 - s) * f
            outs.append(out[0].numpy())
    c["output_layer"]["bias"] -= np.mean(outs, axis=0)
    return p


def _embedders(params):
    return (jemb.RetrievalEmbedder(params=params, feature_dim=DIM),
            temb.RetrievalEmbedder(state=from_jax(params), feature_dim=DIM,
                                   device="cpu"))


@pytest.fixture(scope="module")
def solved(zoo, standin, tmp_path_factory):
    """A local-mode run of the port's agent on the zoo input, inserted
    into a store of each package by its own ``insert_solved_runs``."""
    from image_restoration_agent_tpu_torch.agent import IRAgent
    _, teng, inp = zoo
    params, je, te = standin
    root = tmp_path_factory.mktemp("solved")
    agent = IRAgent(inp, root, executor=texec.build_default_executor(
        engine=teng, toolboxes=_TOOLBOXES), rng_seed=0, with_rollback=False,
        silent=True, device="cpu")
    assert agent.run().exists()
    ep = json.loads(agent.summary_path.read_text())["execution_path"]
    stores = []
    for mod, train, emb in ((jstore, jtrain, je), (tstore, ttrain, te)):
        st = mod.NumpyVectorStore(dim=DIM, embedder=emb)
        assert train.insert_solved_runs(root, st, emb) == 1
        stores.append(st)
    return ep, stores


def test_iragent_clip_retrieval_matches_jax(zoo, solved, tmp_path):
    """The plan is the stored run's subtasks, each tool the stored tool,
    in both packages, with the same trace."""
    from image_restoration_agent_tpu.agent import IRAgent as JAgent
    from image_restoration_agent_tpu_torch.agent import IRAgent
    jeng, teng, inp = zoo
    ep, (js, ts) = solved
    assert ep["subtasks"], ep
    runs = []
    for agent_cls, ex, st, out in (
            (JAgent, jexec.build_default_executor(
                engine=jeng, toolboxes=_TOOLBOXES), js, "j"),
            (IRAgent, texec.build_default_executor(
                engine=teng, toolboxes=_TOOLBOXES), ts, "t")):
        kw = {} if agent_cls is JAgent else {"device": "cpu"}
        agent = agent_cls(inp, tmp_path / out, executor=ex, rng_seed=0,
                          evaluate_degradation_by="clip_retrieval",
                          retrieval_store=st, silent=True, **kw)
        assert agent.run().exists()
        runs.append(_trace(json.loads(agent.summary_path.read_text())))
    assert runs[1] == runs[0]
    assert [s for s, _ in runs[1]["plan"]["initial"]] == ep["subtasks"]
    assert runs[1]["execution_path"]["tools"] == ep["tools"]
    assert runs[1]["n_invocations"] == len(ep["tools"])


def test_graph_app_branches_match_jax(zoo, solved, standin, tmp_path):
    """Retrieval: the input's own solved run (similarity 1). DepictQA: a
    store whose only entry is a different image (similarity under the
    0.9 threshold once the random embedder is centred on the two)."""
    from image_restoration_agent_tpu.agent import run_agent as jrun
    from image_restoration_agent_tpu_torch.agent import run_agent
    jeng, teng, inp = zoo
    ep, (js, ts) = solved
    params = standin[0]
    img = tio.to_float(tio.load_image(inp))
    other = np.ascontiguousarray(img[::-1, ::-1] * 0.5 + 0.25)
    je2, te2 = _embedders(centre(params, [img, other]))
    jo = jstore.NumpyVectorStore(dim=DIM, embedder=je2)
    to = tstore.NumpyVectorStore(dim=DIM, embedder=te2)
    jo.insert(jstore.RetrievalRecord("other", "dehazing_fbcnn",
                                     je2.embed_array(other)))
    to.insert(tstore.RetrievalRecord("other", "dehazing_fbcnn",
                                     te2.embed_array(other)))
    keys = ("initial_plan", "executed", "subtask_success")
    for case, (jst, tst) in (("retrieval", (js, ts)),
                             ("depictqa", (jo, to))):
        want = jrun(inp, tmp_path / f"j{case}", retrieval_store=jst,
                    executor=jexec.build_default_executor(
                        engine=jeng, toolboxes=_TOOLBOXES))
        got = run_agent(inp, tmp_path / f"t{case}", retrieval_store=tst,
                        executor=texec.build_default_executor(
                            engine=teng, toolboxes=_TOOLBOXES),
                        device="cpu")
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert got["retrieval"]["res_seq"] == want["retrieval"]["res_seq"]
        sim = got["retrieval"]["similarity"]
        assert abs(sim - want["retrieval"]["similarity"]) <= 1e-4
        if case == "retrieval":
            assert sim >= 0.9 and "evaluation" not in got
            assert [list(p) for p in got["initial_plan"]] == [
                list(p) for p in zip(ep["subtasks"], ep["tools"])]
        else:
            assert sim < 0.9 and got["evaluation"] == want["evaluation"]
            assert all(t is None for _, t in got["initial_plan"])


def test_cli_infer_clip_retrieval_fault_is_pinned(tmp_path):
    """The reference fault: ``infer --evaluate-by clip_retrieval`` offers
    the mode but builds IRAgent without a retrieval store, so evaluating
    the input calls ``None.embed``. The port keeps the reference's CLI and
    raises the same error; it adds no store the reference lacks."""
    src = tmp_path / "in.png"
    tio.save_image(np.random.default_rng(0).random((32, 32, 3),
                                                   dtype=np.float32), src)
    argv = ["infer", str(src), "--fast", "--evaluate-by", "clip_retrieval"]
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                       "attribute 'embed'"):
        jcli.main(argv + ["-o", str(tmp_path / "j")])
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                       "attribute 'embed'"):
        cli.main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"])
