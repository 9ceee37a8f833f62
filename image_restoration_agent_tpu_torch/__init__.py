"""PyTorch / CUDA port of the image-restoration framework for NVIDIA
Hopper (H100), beside the JAX package ``image_restoration_agent_tpu``,
which stays the reference it is held against.

- ``core``    : pad -> tile -> forward -> overlap-blend -> crop, PNG codec,
                bicubic resizes.
- ``ops``     : window attention, pixel shuffle, LayerNorms, gates, MDTA,
                and the hand-written CUDA kernels of the serving paths
                (``csrc/``): the Swin block (token_linear +
                window_attention, also HAT's half block and the
                partition route's wmsa_block), the Swin shift (roll2d),
                the fused 3x3 conv, and Restormer's fused GDFN and MDTA
                blocks; the lab kernels (the fused Swin block pair and
                3x3 conv pair).
- ``models``  : SwinIR, HAT, Restormer, DehazeFormer, NAFNet and FBCNN
                with reference parameter names.
- ``engine``  : the serving runtime (band mode, shape buckets, weights).
- ``iqa``     : the agent's degradation classifier (v4 weights in
                ``weights/``).
- ``agent``   : IRAgent, the graph app, the executor over the engine,
                evaluators, MockLLM and the HTTP LLM clients.
- ``convert`` : JAX parameter pytrees -> reference-named state dicts.
- ``offline`` : the synthetic real-geometry goldens and their weights.
- ``utils``   : logging helpers.
- ``lab``     : entry points for the kernels no served model reaches
                (``lab_r5``, ``head_pair``, ``kernel_lab``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CUDA tensor every kernel wrapper launches its kernel or raises, on a
CPU tensor it runs its plain PyTorch version.
"""

__version__ = "0.1.0"
