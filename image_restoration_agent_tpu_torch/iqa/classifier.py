"""Degradation classifier: the agent's in-process stand-in for DepictQA
(counterpart of ``image_restoration_agent_tpu/iqa/classifier.py``).

For each of 7 degradations it answers one of five severity levels, from
a small CNN trunk plus 22 analytic priors (``degradation_features``) on
the image resized to 224 px with MATLAB's bicubic (``core/resize.py``).
The shipped weights are the JAX package's v4 checkpoint with the V3
architecture (what its ``SeverityEvaluator.default()`` resolves to),
carried across as ``weights/degradation_classifier_v4.npz`` (the Flax
tree, paths joined by dots; ``convert.write_flat_npz``). The V1
architecture (the JAX package's 160 px and v2 checkpoints) and V5 (the
ordinal CORAL head) load through ``SeverityEvaluator.from_npz`` too, and
``default()`` searches the JAX package's order of checkpoints.

Everything runs in float32 (no TF32 on the card): the argmax decides the
agent's plan and reflections. Where PyTorch's defaults differ from the
Flax and ``jnp`` ones the reference uses, the Flax meaning is kept:
stride-2 SAME convs pad (0, 1) at even sizes, GroupNorm's epsilon is 1e-6,
GELU is the tanh form, the median averages the two middle values, the
variance divides by N, the priors' even SAME kernels pad the extra row and
column at the bottom/right, and the 7x7 min pool pads with +inf.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.resize import resize_matlab
from ..device import exact_f32, resolve_device
from ..models.registry import init_weights

SEVERITY_LEVELS = ["very low", "low", "medium", "high", "very high"]

DEGRADATIONS = [
    "low resolution",
    "noise",
    "motion blur",
    "defocus blur",
    "haze",
    "rain",
    "dark",
    "jpeg compression artifact",
]

# The 7 degradations the evaluator scores (low resolution is the agent's
# size heuristic instead).
EVALUATED_DEGRADATIONS = [d for d in DEGRADATIONS if d != "low resolution"]

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" \
    / "degradation_classifier_v4.npz"


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one axis: (low, high), the odd one at the
    end."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv2(img: torch.Tensor, k) -> torch.Tensor:
    """(B, H, W) SAME cross-correlation with a small fixed kernel."""
    kt = torch.tensor(k, dtype=torch.float32, device=img.device)
    (t, b), (l, r) = (_same_pad(img.shape[1], kt.shape[0], 1),
                      _same_pad(img.shape[2], kt.shape[1], 1))
    x = F.pad(img[:, None], (l, r, t, b))
    return F.conv2d(x, kt[None, None])[:, 0]


def _quantile(x: torch.Tensor, q, interpolation: str = "linear"):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.quantile(x, qt, dim=-1, keepdim=qt.dim() == 0,
                          interpolation=interpolation)


def degradation_features(x: torch.Tensor) -> torch.Tensor:
    """Hand-derived per-degradation signals, (B, H, W, 3) in [0,1] ->
    (B, 22): darkness (luminance mean, 5/50/95 percentiles, variance),
    noise (median-absolute Laplacian, checkerboard residual), blur (gradient
    energy and its 95th percentile, structure-tensor anisotropy, fine
    energy and its ratio), JPEG (8-grid blockiness), haze (dark channel,
    saturation, local contrast) and rain (vertical high-pass energy, bright
    streaks), log-scaled."""
    if x.is_cuda:
        exact_f32()
    x = x.float()
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    b = lum.shape[0]
    flat = lum.reshape(b, -1)

    q = _quantile(flat, [0.05, 0.5, 0.95]).T
    mean_l = flat.mean(-1, keepdim=True)

    lap = _conv2(lum, [[0, 1, 0], [1, -4, 1], [0, 1, 0]])
    # jnp.median: the mean of the two middle values at an even count
    lap_mad = _quantile(lap.abs().reshape(b, -1), 0.5, "midpoint")
    chk = _conv2(lum, [[1, -1], [-1, 1]])
    chk_e = chk.abs().reshape(b, -1).mean(-1, keepdim=True)

    gx = _conv2(lum, [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8.0
    gy = _conv2(lum, [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]) / 8.0
    ge = (gx * gx + gy * gy).reshape(b, -1)
    grad_e = ge.mean(-1, keepdim=True)
    grad_p95 = _quantile(ge, 0.95)
    jxx = (gx * gx).reshape(b, -1).mean(-1)
    jyy = (gy * gy).reshape(b, -1).mean(-1)
    jxy = (gx * gy).reshape(b, -1).mean(-1)
    aniso = (torch.sqrt((jxx - jyy) ** 2 + 4 * jxy ** 2)
             / (jxx + jyy + 1e-8))[:, None]
    box = (np.ones((5, 5), np.float32) / 25.0).tolist()
    coarse = _conv2(lum, box)
    fine_e = ((lum - coarse) ** 2).reshape(b, -1).mean(-1, keepdim=True)
    var_l = flat.var(-1, correction=0, keepdim=True)
    hf_ratio = fine_e / (var_l + 1e-8)

    dx = (lum[:, :, 1:] - lum[:, :, :-1]).abs()
    dy = (lum[:, 1:, :] - lum[:, :-1, :]).abs()
    at8_c = (torch.arange(dx.shape[2], device=x.device) % 8) == 7
    at8_r = (torch.arange(dy.shape[1], device=x.device) % 8) == 7
    bx = dx.mean(1)
    by = dy.mean(2)
    block_c = (bx * at8_c).sum(-1) / (at8_c.sum() + 1e-8)
    off_c = (bx * ~at8_c).sum(-1) / ((~at8_c).sum() + 1e-8)
    block_r = (by * at8_r).sum(-1) / (at8_r.sum() + 1e-8)
    off_r = (by * ~at8_r).sum(-1) / ((~at8_r).sum() + 1e-8)
    blockiness = ((block_c + block_r) / (off_c + off_r + 1e-8))[:, None]

    # 7x7 min pool, +inf outside the image
    dark = -F.max_pool2d(-x.amin(-1)[:, None], 7, 1, 3)[:, 0]
    dark_mean = dark.reshape(b, -1).mean(-1, keepdim=True)
    mx, mn = x.amax(-1), x.amin(-1)
    sat = ((mx - mn) / (mx + 1e-6)).reshape(b, -1).mean(-1, keepdim=True)
    loc_mu = coarse
    loc_var = _conv2(lum * lum, box) - loc_mu * loc_mu
    contrast = torch.sqrt(loc_var.clamp_min(0.0)).reshape(b, -1) \
        .mean(-1, keepdim=True)

    vert = _conv2(lum, [[-0.5], [1.0], [-0.5]])
    rain_e = vert.clamp_min(0.0).reshape(b, -1).mean(-1, keepdim=True)
    streak = (lum - coarse).clamp_min(0.0)
    streak_p99 = _quantile(streak.reshape(b, -1), 0.99)

    feats = torch.cat([
        mean_l, q, var_l,
        lap_mad, chk_e,
        grad_e, grad_p95, aniso, fine_e, hf_ratio,
        blockiness, torch.stack([block_c, off_c, block_r, off_r], dim=-1),
        dark_mean, sat, contrast,
        rain_e, streak_p99,
    ], dim=-1)
    return torch.log1p(feats * 100.0)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # Flax nn.gelu's default form


class ConvTrunk:
    """Stride-2 SAME 3x3 convs, each followed by GroupNorm(8) and GELU,
    then a global average pool: the trunk of every classifier and of the
    retrieval stand-in's image tower. Its parameters sit on the owner
    under the Flax names (``conv{i}``, ``gn{i}``), so this is a mixin of
    helpers, not a submodule."""

    def _add_trunk(self, widths: tuple[int, ...]) -> None:
        chans = (3, *widths)
        for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
            setattr(self, f"conv{i}", nn.Conv2d(a, b, 3, stride=2))
            setattr(self, f"gn{i}", nn.GroupNorm(8, b, eps=1e-6))
        self.depth = len(widths)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, widths[-1])."""
        y = x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            (t, b), (l, r) = (_same_pad(y.shape[2], 3, 2),
                              _same_pad(y.shape[3], 3, 2))
            y = getattr(self, f"conv{i}")(F.pad(y, (l, r, t, b)))
            y = _gelu(getattr(self, f"gn{i}")(y))
        return y.mean(dim=(2, 3))


class DegradationClassifier(ConvTrunk, nn.Module):
    """The v1 classifier (the 160 px and v2 checkpoints): a 4-stage conv
    trunk -> fc1 -> (8, 5) severity logits. Flax names (``conv{i}``,
    ``gn{i}``, ``fc1``, ``head``)."""

    def __init__(self, width: int = 32, num_levels: int = 5):
        super().__init__()
        self.num_levels = num_levels
        self._add_trunk((width, width * 2, width * 4, width * 4))
        self.fc1 = nn.Linear(width * 4, width * 8)
        self.head = nn.Linear(width * 8, len(DEGRADATIONS) * num_levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, S, S, 3)
        if x.is_cuda:
            exact_f32()
        z = _gelu(self.fc1(self._trunk(x)))
        return self.head(z).reshape(z.shape[0], len(DEGRADATIONS),
                                    self.num_levels)


class DegradationClassifierV3(ConvTrunk, nn.Module):
    """CNN trunk + analytic degradation priors -> (8, 5) severity logits.
    Parameter names are the Flax module's (``conv{i}``, ``gn{i}``,
    ``feat_fc``, ``fc1``, ``fc2``, ``head``)."""

    def __init__(self, width: int = 32, num_levels: int = 5):
        super().__init__()
        self.num_levels = num_levels
        self._add_trunk((width, width * 2, width * 4, width * 4, width * 8))
        self.feat_fc = nn.Linear(22, width * 4)
        self.fc1 = nn.Linear(width * 8 + width * 4, width * 8)
        self.fc2 = nn.Linear(width * 8, width * 8)
        self.head = nn.Linear(width * 8, len(DEGRADATIONS) * num_levels)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk and the priors through fc1 and fc2: (B, 8 * width)."""
        if x.is_cuda:
            exact_f32()
        z = torch.cat([self._trunk(x),
                       _gelu(self.feat_fc(degradation_features(x)))], -1)
        return _gelu(self.fc2(_gelu(self.fc1(z))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, S, S, 3)
        z = self._features(x)
        return self.head(z).reshape(z.shape[0], len(DEGRADATIONS),
                                    self.num_levels)


class DegradationClassifierV5(DegradationClassifierV3):
    """The v3 trunk with an ordinal (CORAL) severity head: one score per
    degradation against 4 learned thresholds kept increasing by a
    cumulative softplus, ``P(level > k) = sigmoid(score - t_k)``.
    ``forward`` returns the 5 levels' log-probabilities, shaped like the v3
    logits; ``cumulative=True`` returns the 4 cumulative logits. Flax names
    (``score``, ``thresh0``, ``thresh_deltas``)."""

    def __init__(self, width: int = 32, num_levels: int = 5):
        super().__init__(width, num_levels)
        del self.head
        nd = len(DEGRADATIONS)
        self.score = nn.Linear(width * 8, nd)
        self.thresh0 = nn.Parameter(torch.zeros(nd, 1))
        self.thresh_deltas = nn.Parameter(
            torch.full((nd, num_levels - 2), 0.55))

    def forward(self, x: torch.Tensor,
                cumulative: bool = False) -> torch.Tensor:
        score = self.score(self._features(x))                # (B, nd)
        thresh = torch.cat([self.thresh0, self.thresh0 + torch.cumsum(
            F.softplus(self.thresh_deltas), dim=-1)], dim=-1)
        cum = score[:, :, None] - thresh[None]               # (B, nd, L-1)
        if cumulative:
            return cum
        sig = torch.sigmoid(cum)                             # decreasing
        upper = torch.cat([torch.ones_like(sig[..., :1]), sig], -1)
        lower = torch.cat([sig, torch.zeros_like(sig[..., :1])], -1)
        return torch.log(upper - lower + 1e-9)


def architecture_of(state: dict) -> type:
    """The classifier class whose parameters ``state`` holds (V5 by its
    ``score``, V3 by its ``feat_fc``, else V1)."""
    if "score.weight" in state:
        return DegradationClassifierV5
    if "feat_fc.weight" in state:
        return DegradationClassifierV3
    return DegradationClassifier


def prepare_input(img, size: int = 224) -> torch.Tensor:
    """Resize an (H, W, 3) float image (numpy, or a tensor on any device)
    to the classifier's (size, size, 3) input with MATLAB's bicubic, as a
    float32 tensor on the image's device (numpy: the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)) \
        if isinstance(img, np.ndarray) else img.float()
    return resize_matlab(x, out_shape=(size, size))


# the shipped checkpoints in default()'s order: (file stem, architecture
# or None for the v5 slot's marker, input size)
_SHIPPED = (("degradation_classifier_v5", None, 224),
            ("degradation_classifier_v4", DegradationClassifierV3, 224),
            ("degradation_classifier_v3", DegradationClassifierV3, 224),
            ("degradation_classifier_v2", DegradationClassifier, 224),
            ("degradation_classifier", DegradationClassifier, 160))


class SeverityEvaluator:
    """Callable evaluator with the DepictQA decision contract:
    ``evaluate(img) -> [(degradation, severity), ...]`` for the 7 evaluated
    degradations, and ``severity_of(img, degradation) -> level``.

    ``state`` is the model's state dict (random weights from ``rng_seed``
    without one); images are float (H, W, 3) numpy arrays in [0, 1]."""

    def __init__(self, state: dict | None = None,
                 model: nn.Module | None = None, rng_seed: int = 0,
                 input_size: int = 224, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model or DegradationClassifierV3()
        if state is None:
            init_weights(self.model, rng_seed)
        else:
            self.model.load_state_dict(state, strict=True)
        self.model = self.model.to(self.device, torch.float32).eval()
        self.input_size = input_size
        self._logit_cache: dict = {}

    @classmethod
    def from_npz(cls, path: str | Path = WEIGHTS, input_size: int = 224,
                 model: nn.Module | None = None,
                 device: str | torch.device = "cuda") -> "SeverityEvaluator":
        """Serve a Flax classifier tree written by ``write_flat_npz`` (the
        counterpart of the JAX ``from_checkpoint``); without ``model`` the
        architecture is read from the tree's names."""
        from ..convert.from_jax import from_jax, read_flat_npz
        state = from_jax(read_flat_npz(path))
        return cls(state=state, model=model or architecture_of(state)(),
                   input_size=input_size, device=device)

    _default: dict = {}

    @classmethod
    def default(cls, device: str | torch.device = "cuda",
                weights: str | Path | None = None) -> "SeverityEvaluator":
        """The best shipped classifier on ``device``, one instance per
        device for the process (its logit cache is shared by every agent
        run). The JAX package's search order over ``weights`` (the port's
        ``weights/``): the v5 slot (its ``.arch`` marker says ``coral``,
        the default, or ``softmax`` for the V3 head), v4, v3, v2 (V1 at
        224 px), then the 160 px v1; random weights where none exists. A
        file that exists and does not load raises."""
        root = Path(weights) if weights else WEIGHTS.parent
        key = (str(resolve_device(device)), str(root))
        if key not in cls._default:
            inst = None
            for stem, arch, size in _SHIPPED:
                path = root / f"{stem}.npz"
                if not path.exists():
                    continue
                if arch is None:
                    marker = root / f"{stem}.arch"
                    coral = not marker.exists() or \
                        marker.read_text().strip() == "coral"
                    arch = DegradationClassifierV5 if coral \
                        else DegradationClassifierV3
                inst = cls.from_npz(path, input_size=size, model=arch(),
                                    device=key[0])
                break
            cls._default[key] = inst or cls(device=key[0])
        return cls._default[key]

    @torch.no_grad()
    def logits(self, img: np.ndarray) -> np.ndarray:
        # the agent's reflection loop asks severity_of() per degradation
        # on the SAME image: memoize the last few forwards. The key hashes
        # the FULL buffer: a subsampled fingerprint returned stale logits
        # for restoration ops that only touch pixels off the sparse grid
        # (e.g. localized rain-streak removal), hiding real severity
        # changes from the reflection loop. Hashing ~MBs costs far less
        # than one forward.
        key = (img.shape, img.dtype.str,
               hash(np.ascontiguousarray(img).tobytes()))
        cache = self._logit_cache
        if key not in cache:
            x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
                self.device)
            x = prepare_input(x, self.input_size)[None]
            cache[key] = self.model(x)[0].cpu().numpy()
            if len(cache) > 16:
                cache.pop(next(iter(cache)))
        return cache[key]

    def evaluate(self, img: np.ndarray) -> list[tuple[str, str]]:
        lg = self.logits(img)
        return [(d, SEVERITY_LEVELS[int(lg[DEGRADATIONS.index(d)].argmax())])
                for d in EVALUATED_DEGRADATIONS]

    def severity_of(self, img: np.ndarray, degradation: str) -> str:
        lg = self.logits(img)
        return SEVERITY_LEVELS[int(lg[DEGRADATIONS.index(degradation)]
                                   .argmax())]

    def severity_with_confidence(self, img: np.ndarray,
                                 degradation: str) -> tuple[str, float]:
        """Severity plus the softmax probability of the chosen level (the
        classifier's analog of DepictQA's token-probability confidence)."""
        row = self.logits(img)[DEGRADATIONS.index(degradation)]
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        j = int(probs.argmax())
        return SEVERITY_LEVELS[j], float(probs[j])
