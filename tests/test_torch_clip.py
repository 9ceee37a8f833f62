"""Port parity for CLIP and what runs on it: both towers (with and without
the attention pool's positional embedding), ``preprocess`` (target-pad and
centre-crop), the BPE tokenizer (ids, and the one pinned difference in its
character classes), the Combiner, ``CLIPRetrievalEmbedder`` and
``ClipIQA``, each held against the JAX package's
``retrieval/clip.py``, ``tokenizer.py``, ``combiner.py``, ``embedder.py``
and ``iqa/clipiqa.py`` with the weights carried by ``convert.from_jax``;
and against the published architecture's torch transcription
(``tests/test_clip.py``'s ``TCLIP``), loaded with ``strict=True``."""

import gzip
import itertools
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from image_restoration_agent_tpu.iqa import clipiqa as jiqa
from image_restoration_agent_tpu.retrieval import clip as jclip
from image_restoration_agent_tpu.retrieval import embedder as jemb
from image_restoration_agent_tpu.retrieval import tokenizer as jtok
from image_restoration_agent_tpu.retrieval.combiner import Combiner as JComb
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.iqa import clipiqa as tiqa
from image_restoration_agent_tpu_torch.retrieval import clip as tclip
from image_restoration_agent_tpu_torch.retrieval import embedder as temb
from image_restoration_agent_tpu_torch.retrieval import tokenizer as ttok
from image_restoration_agent_tpu_torch.retrieval.combiner import Combiner

import test_clip as ref_clip

torch.set_num_threads(1)

# tiny config: vision (1, 1, 1, 1) x width 16 (attnpool 512 wide, 8 heads),
# embed 32; text 2 layers x width 32, 2 heads, CLIP's vocab and context
CFG = dict(embed_dim=32, vision_layers=(1, 1, 1, 1), vision_width=16,
           image_resolution=64, text_width=32, text_layers=2, text_heads=2,
           vocab_size=49408, context_length=77)
RES = 64


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def random_tree(shapes, seed: int):
    """Fan-in scaled normal weights for a JAX tree; FrozenBN statistics
    with a positive variance and scales near 1, so every BN does work."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = jax.tree_util.keystr(path[-1:])
        n = rng.standard_normal(a.shape).astype(np.float32)
        if "var" in leaf:
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if "scale" in leaf:
            return 1.0 + 0.1 * n
        if len(a.shape) <= 1:
            return 0.05 * n
        return n / np.sqrt(np.prod(a.shape[:-1])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_clip(attnpool_pos: bool = True, seed: int = 0, **over):
    cfg = {**CFG, **over}
    m = jclip.CLIPModel(**cfg, attnpool_pos=attnpool_pos)
    res = cfg["image_resolution"]
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)),
        jnp.zeros((1, cfg["context_length"]), jnp.int32)))
    return m, random_tree(shapes, seed)


def port_clip(params, attnpool_pos: bool = True, **over):
    m = tclip.CLIPModel(**{**CFG, **over}, attnpool_pos=attnpool_pos)
    m.load_state_dict(from_jax(params), strict=True)
    return m.eval()


def _ids(n: int = 3, ctx: int = 77, vocab: int = 49408) -> np.ndarray:
    rng = np.random.default_rng(7)
    ids = np.zeros((n, ctx), np.int32)
    for i, length in enumerate((5, 12, ctx)[:n]):
        ids[i, 0] = vocab - 2
        ids[i, 1:length - 1] = rng.integers(1, vocab - 2, length - 2)
        ids[i, length - 1] = vocab - 1
    return ids


@pytest.fixture(scope="module", params=[True, False], ids=["pos", "nopos"])
def clip_pair(request):
    m, params = jax_clip(request.param)
    return request.param, m, params, port_clip(params, request.param)


def test_clip_image_tower_matches_jax(clip_pair):
    pos, m, params, pm = clip_pair
    sizes = [(RES, RES)] + ([] if pos else [(96, 80)])
    for i, (h, w) in enumerate(sizes):
        x = np.random.default_rng(i).standard_normal(
            (2, h, w, 3)).astype(np.float32)
        want = np.asarray(jax.jit(lambda p, a: m.apply(
            p, a, method=jclip.CLIPModel.encode_image))(params, x))
        with torch.no_grad():
            got = pm.encode_image(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, CFG["embed_dim"])
        assert rel_err(got, want) <= 1e-4, (h, w)


def test_clip_text_tower_matches_jax(clip_pair):
    _, m, params, pm = clip_pair
    ids = _ids()
    want = np.asarray(jax.jit(lambda p, t: m.apply(
        p, t, method=jclip.CLIPModel.encode_text))(params, ids))
    with torch.no_grad():
        got = pm.encode_text(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (3, CFG["embed_dim"])
    assert rel_err(got, want) <= 1e-4


def test_clip_loads_the_published_layout_strictly():
    """tests/test_clip.py's TCLIP (OpenAI CLIP's module names, torch
    BatchNorm and nn.MultiheadAttention) loads into the port with
    ``strict=True`` and gives its outputs. Its text LayerNorms have
    CLIP's eps 1e-5, the port's the JAX package's 1e-6."""
    torch.manual_seed(0)
    tm = ref_clip.TCLIP().eval()
    with torch.no_grad():  # running statistics that do something
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    pm = tclip.CLIPModel(
        embed_dim=ref_clip.EMBED, vision_layers=ref_clip.V_LAYERS,
        vision_width=ref_clip.V_WIDTH, image_resolution=ref_clip.RES,
        text_width=ref_clip.T_WIDTH, text_layers=ref_clip.T_LAYERS,
        text_heads=ref_clip.T_HEADS, vocab_size=ref_clip.VOCAB,
        context_length=ref_clip.CTX).eval()
    pm.load_state_dict(tm.state_dict(), strict=True)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, ref_clip.RES, ref_clip.RES, 3)).astype(np.float32))
    ids = torch.from_numpy(_ids(2, ref_clip.CTX, ref_clip.VOCAB)).long()
    with torch.no_grad():
        want_i = tm.encode_image(img.permute(0, 3, 1, 2)).numpy()
        want_t = tm.encode_text(ids).numpy()
        got_i = pm.encode_image(img).numpy()
        got_t = pm.encode_text(ids).numpy()
    assert rel_err(got_i, want_i) <= 1e-4
    assert rel_err(got_t, want_t) <= 1e-4


def test_from_jax_names_are_the_published_ones():
    _, params = jax_clip()
    sd = from_jax(params)
    for key in ("visual.layer2.0.downsample.1.running_var",
                "visual.layer2.0.downsample.0.weight",
                "visual.attnpool.positional_embedding",
                "transformer.resblocks.1.attn.in_proj_weight",
                "transformer.resblocks.0.mlp.c_proj.bias",
                "token_embedding.weight", "text_projection", "logit_scale",
                "visual.bn3.num_batches_tracked"):
        assert key in sd, key
    assert sd["transformer.resblocks.1.attn.in_proj_weight"].shape == (96, 32)
    assert float(sd["logit_scale"].exp()) == pytest.approx(100.0)


@pytest.mark.parametrize("shape,n_px,ratio", [
    ((100, 160, 3), 64, 1.25),   # wide: padded to the ratio, downscaled
    ((90, 100, 3), 64, 1.25),    # near square: no pad
    ((160, 100, 3), 64, 1.25),   # tall
    ((100, 160, 3), 64, None),   # shorter side to 64, centre crop
    ((40, 50, 3), 64, None),     # upscale
    ((81, 57, 3), 288, 1.25),    # the retrieval size, an odd pad
], ids=["wide", "square", "tall", "crop", "upscale", "n288"])
def test_preprocess_matches_jax(shape, n_px, ratio):
    img = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    want = jclip.preprocess(img, n_px=n_px, target_ratio=ratio)
    got = tclip.preprocess(img, n_px=n_px, target_ratio=ratio).numpy()
    assert got.shape == want.shape == (n_px, n_px, 3)
    assert rel_err(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# tokenizer

CAPTIONS = [
    "similar degradation", "Good photo.", "Bad photo.",
    "It's a dog's life, isn't it? We've seen they'll do what you'd want; "
    "I'm sure it'd work.",
    "Photo 2024, taken at 10:30 -- f/2.8 @ISO_3200!!",
    "  many   spaces\tand\nnew lines  ",
    "&amp; html &lt;escapes&gt; &amp;amp;",
    "café naïve résumé Ångström Straße",
    "emoji 🙂 and symbols ©®™ ±×÷",
    " ".join(["degradation"] * 90),  # past the context: truncated
]


def _merges_file(path) -> str:
    """A merges file (the vocab's 48894 entries after the version line)
    whose first merges build every word of ``CAPTIONS`` left to right, the
    rest unique pairs of byte symbols."""
    b2u = jtok.bytes_to_unicode()
    head, seen = [], set()
    words = {w for c in CAPTIONS for w in regex.findall(jtok._PAT,
                                                        c.lower())}
    for w in sorted(words)[:200]:
        sym = [b2u[b] for b in w.encode("utf-8")]
        sym[-1] += "</w>"
        cur = sym[0]
        for s in sym[1:]:
            m = f"{cur} {s}"
            if m not in seen:
                seen.add(m)
                head.append(m)
            cur += s
    alphabet = list(b2u.values())
    need = 49152 - 256 - 2 - len(head)
    pad = []
    for a, b in itertools.product(alphabet, alphabet):
        m = f"{a} {b}"
        if m not in seen:
            pad.append(m)
            if len(pad) == need:
                break
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + head + pad))
    return str(path)


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    return _merges_file(tmp_path_factory.mktemp("bpe") / "bpe.txt.gz")


def test_tokenizer_ids_match_jax(bpe):
    jt, tt = jtok.SimpleTokenizer(bpe), ttok.SimpleTokenizer(bpe)
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    assert (tt.sot_id, tt.eot_id) == (jt.sot_id, jt.eot_id) == (49406,
                                                               49407)
    for text in CAPTIONS:
        assert tt.encode(text) == jt.encode(text), text
    want = jt.tokenize(CAPTIONS)
    got = tt.tokenize(CAPTIONS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == tt.eot_id  # truncated, ends in EOT
    # the merges apply: "similar" is one token, not seven
    assert len(tt.encode("similar")) == 1
    np.testing.assert_array_equal(tt.tokenize("x", context_length=8),
                                  jt.tokenize("x", context_length=8))


def test_tokenizer_character_classes_differ_only_where_pinned():
    """The port's stdlib ``re`` pattern splits every character as the JAX
    package's ``regex`` pattern (``\\p{L}``, ``\\p{N}``) does, except the
    numbers that are not decimal digits (categories Nl and No: ``re``
    counts them as word characters, so they join a run of letters), the
    four information separators U+001C-U+001F (whitespace to ``re``) and
    U+0345 (which ``regex`` case-folds to a letter). Unassigned code
    points are not compared (the two modules' Unicode versions differ)."""
    diff = {}
    for cp in range(0x110000):
        c = chr(cp)
        cat = unicodedata.category(c)
        if cat in ("Cn", "Cs"):
            continue
        s = "a" + c + "1"
        if regex.findall(jtok._PAT, s) != ttok._PAT.findall(s):
            diff.setdefault(cat, []).append(cp)
    assert set(diff) == {"No", "Nl", "Cc", "Mn"}
    assert diff["Cc"] == [0x1C, 0x1D, 0x1E, 0x1F]
    assert diff["Mn"] == [0x345]
    no_nl = sum(unicodedata.category(chr(cp)) in ("No", "Nl")
                for cp in range(0x110000))
    assert len(diff["No"]) + len(diff["Nl"]) == no_nl
    # an example of each: one token per number in JAX, joined in the port
    assert regex.findall(jtok._PAT, "x½y") == ["x", "½", "y"]
    assert ttok._PAT.findall("x½y") == ["x½y"]
    assert regex.findall(jtok._PAT, "ⅻ") == ttok._PAT.findall("ⅻ") == ["ⅻ"]
    assert regex.findall(jtok._PAT, "aⅫb") == ["a", "Ⅻ", "b"]
    assert ttok._PAT.findall("aⅫb") == ["aⅫb"]


# ---------------------------------------------------------------------------
# Combiner, the CLIP embedder, CLIP-IQA

def test_combiner_matches_jax():
    fdim, proj, hid = 16, 32, 64
    jm = JComb(fdim, proj, hid)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, fdim)), jnp.zeros((1, fdim))))
    params = random_tree(shapes, 3)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((3, fdim)).astype(np.float32)
    txt = rng.standard_normal((3, fdim)).astype(np.float32)
    want = np.asarray(jm.apply(params, img, txt))
    pm = Combiner(fdim, proj, hid).eval()
    pm.load_state_dict(from_jax(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(img), torch.from_numpy(txt)).numpy()
    assert rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert "dynamic_scalar.3.weight" in pm.state_dict()


def test_clip_retrieval_embedder_matches_jax(bpe):
    m, params = jax_clip(seed=5)
    comb = JComb(CFG["embed_dim"], 32, 64)
    cshapes = jax.eval_shape(lambda: comb.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32)), jnp.zeros((1, 32))))
    cparams = random_tree(cshapes, 6)
    je = jemb.CLIPRetrievalEmbedder(
        params, cparams, jtok.SimpleTokenizer(bpe), n_px=RES,
        feature_dim=CFG["embed_dim"], clip_model=m, combiner_model=comb)
    te = temb.CLIPRetrievalEmbedder(
        from_jax(params), from_jax(cparams), ttok.SimpleTokenizer(bpe),
        n_px=RES, feature_dim=CFG["embed_dim"],
        clip_model=tclip.CLIPModel(**CFG),
        combiner_model=Combiner(CFG["embed_dim"], 32, 64), device="cpu")
    assert te.identity == je.identity == "clip4cir_rn50x4"
    rng = np.random.default_rng(5)
    for shape in ((90, 120, 3), (64, 64, 3)):
        img = rng.random(shape, dtype=np.float32)
        want = je.embed_array(img)
        got = te.embed_array(img)
        assert got.shape == want.shape == (CFG["embed_dim"],)
        assert rel_err(got, want) <= 1e-4
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)


@pytest.mark.parametrize("native", [True, False], ids=["native", "crop"])
def test_clipiqa_matches_jax(bpe, native):
    m, params = jax_clip(attnpool_pos=not native, seed=8)
    pm = tclip.CLIPModel(**CFG, attnpool_pos=not native)
    ji = jiqa.ClipIQA(params, tokenizer=jtok.SimpleTokenizer(bpe),
                      clip_model=m, n_px=RES, native_resolution=native)
    ti = tiqa.ClipIQA(from_jax(params), tokenizer=ttok.SimpleTokenizer(bpe),
                      clip_model=pm, n_px=RES, native_resolution=native,
                      device="cpu")
    assert ti.native == ji.native == native
    rng = np.random.default_rng(9)
    for shape in ((70, 90, 3), (64, 64, 3)):
        img = rng.random(shape, dtype=np.float32)
        want, got = ji(img), ti(img)
        assert 0.0 <= got <= 1.0
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3), shape
    # precomputed prompt features take the tokenizer's place
    tf = np.random.default_rng(0).standard_normal(
        (2, CFG["embed_dim"])).astype(np.float32)
    ji2 = jiqa.ClipIQA(params, clip_model=m, text_features=tf, n_px=RES,
                       native_resolution=native)
    ti2 = tiqa.ClipIQA(None, clip_model=ti.clip, text_features=tf,
                       n_px=RES, native_resolution=native, device="cpu")
    img = rng.random((72, 64, 3), dtype=np.float32)
    assert abs(ti2(img) - ji2(img)) <= 1e-4 * max(abs(ji2(img)), 1e-3)


def test_clipiqa_default_model_is_rn50():
    """Without a model: CLIP ResNet-50 (CLIP-IQA's default), native mode
    without the pool's positional embedding; built on the meta device."""
    with torch.device("meta"):
        m = tclip.CLIPModel(**tiqa.RN50_CONFIG, attnpool_pos=False)
    assert tiqa.RN50_CONFIG == jiqa.RN50_CONFIG
    assert tiqa.PROMPTS == jiqa.PROMPTS
    assert m.visual.attnpool.positional_embedding is None
    assert m.visual.attnpool.c_proj.out_features == 1024
    assert m.visual.attnpool.num_heads == 32
