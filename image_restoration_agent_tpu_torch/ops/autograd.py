"""Gradients through the hand-written kernels.

The JAX package writes no backward for any of its TPU kernels (no
``custom_vjp``, and ``pallas_call`` cannot be transposed), so a kernel of
the port takes its plain PyTorch version's VJP as its backward.
:func:`kernel_function` wraps a kernel's launch and its plain version in
one ``torch.autograd.Function``:

- forward: the kernel on a CUDA tensor, the plain version on a CPU tensor,
  both without recording a graph, exactly as the wrappers run them;
- backward: the plain version again, under ``enable_grad``, on the saved
  and detached inputs, and ``torch.autograd.grad`` of its outputs.

A kernel's weight form (``Conv3x3Weights``, ``GdfnWeights``,
``MdtaWeights``, K1's :func:`ops.swin_block.kernel_matrix`, a Swin block's
``SwinBlockParams``) is a side input that is not differentiated; the
reference-layout parameters it was made from are the differentiable
inputs. Where no input needs a gradient the launch runs bare, so serving
is unchanged. Every kernel of a trained path has this backward: K3, K4,
K5, K1 ``token_linear``, K2 ``window_attention``, K6 ``roll2d`` and the
Swin wrappers built on K1 and K2 (``mlp_block``, ``swin_block``,
``swin_attn_block``, ``wmsa_block``; ``wmsa`` is K2 alone). A wrapper's
backward recomputes its block from the saved input, so a Swin block keeps
only its input for the backward.

:func:`forbid_grad` guards the kernels that no trained path runs and that
have no backward (the lab kernels K7 ``conv3x3_pair``, K8
``swin_pair_block`` and ``lab_strip``): under autograd they raise rather
than drop a gradient.
"""

from __future__ import annotations

from typing import Callable

import torch


def _needs_grad(inputs) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


def kernel_function(name: str, launch: Callable, plain: Callable
                    ) -> Callable:
    """``call(side, *inputs)``: ``launch(side, *inputs)`` where the first
    input is a CUDA tensor, else ``plain(side, *inputs)``; differentiable
    in ``inputs`` (tensors or None) through ``plain``'s VJP. ``side`` is
    anything the function needs besides its inputs (weight forms, flags)."""

    def forward_run(side, inputs):
        if inputs[0].is_cuda:
            return launch(side, *inputs)
        return plain(side, *inputs)

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, side, *inputs):
            ctx.side = side
            ctx.save_for_backward(*inputs)
            return forward_run(side, inputs)

        @staticmethod
        def backward(ctx, *grads):
            wanted = ctx.needs_input_grad[1:]
            inputs = [None if t is None else
                      t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, wanted)]
            with torch.enable_grad():
                outs = plain(ctx.side, *inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            leaves = [t for t in inputs if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], leaves, [g for _, g in pairs],
                allow_unused=True) if pairs and leaves else ())
            return (None, *(next(got) if t is not None and t.requires_grad
                            else None for t in inputs))

    Function.__name__ = Function.__qualname__ = f"{name}_function"

    def call(side, *inputs):
        if _needs_grad(inputs):
            return Function.apply(side, *inputs)
        return forward_run(side, inputs)

    return call


def _tensors(objs):
    for o in objs:
        if isinstance(o, torch.Tensor):
            yield o
        elif isinstance(o, (tuple, list)):
            yield from _tensors(o)


def forbid_grad(name: str, *operands) -> None:
    """Raise ``RuntimeError`` if autograd would need a gradient through the
    kernel ``name``, which has no backward: grad is enabled and a tensor
    among ``operands`` (nested tuples and lists, e.g. ``SwinBlockParams``,
    are searched) requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors(operands)):
        raise RuntimeError(
            f"{name}: this kernel has no backward, and an operand requires "
            "grad; call it under torch.no_grad() (training through it is "
            "not ported)")
