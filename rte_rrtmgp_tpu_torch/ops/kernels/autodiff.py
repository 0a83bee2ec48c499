"""Gradients through the CUDA kernels.

Counterpart of the JAX package's ``ops/pallas/autodiff.py::with_xla_grad``
and of its ``jax.custom_vjp`` adjoint kernels. A kernel writes into
tensors made with ``torch.empty``, so its output carries no autograd
history; every differentiable kernel call goes through one
``torch.autograd.Function``:

  * forward: ``kernel_fn`` (the wrapper, which launches the kernel on CUDA
    tensors and runs its plain twin on CPU tensors);
  * backward: on CUDA tensors the hand-written adjoint kernel where the
    JAX package has one (:func:`with_adjoint`), else ``torch.autograd.
    grad`` of the plain twin recomputed from the saved inputs under
    ``torch.enable_grad()`` (:func:`with_twin_grad`, and the CPU side of
    :func:`with_adjoint`).

The Function saves its inputs and nothing the forward computed: the
backward recomputes the forward, as the JAX package's does, so no
(ncol, nlay, ngpt) intermediate lives between the passes. Arguments may
be nested tuples and NamedTuples; their tensors are the Function's
inputs, everything else passes through, and integer tensors get no
gradient. A kernel wrapper called outside these Functions with an input
that requires grad raises (:func:`refuse_grad`) rather than return an
output without a gradient.
"""
from __future__ import annotations

import torch

from ... import trace
from ._build import on_cpu

__all__ = ["with_twin_grad", "with_adjoint", "refuse_grad", "none_like"]


def _tensors(tree, out):
    """The tensors of a nested tuple / NamedTuple / list, in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    return out


_SLOT = object()     # a tensor's place in a template


def _rebuild(tree, leaves):
    """``tree`` with its tensors (or slots) replaced, in order, by
    ``leaves`` (an iterator)."""
    if tree is _SLOT or isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return tree


def none_like(tree):
    """``tree`` with every tensor replaced by None: the template an
    adjoint fills with ``_replace`` for the inputs it differentiates."""
    n = len(_tensors(tree, []))
    return _rebuild(tree, iter([None] * n))


def _template(tree):
    """``tree`` with a slot at each tensor, so that a Function keeps no
    reference to its inputs besides the saved ones."""
    n = len(_tensors(tree, []))
    return _rebuild(tree, iter([_SLOT] * n))


def _grads_at_tensors(tree, grads, out):
    """The entries of ``grads`` (a structure parallel to ``tree``) at the
    positions where ``tree`` holds a tensor, in order."""
    if tree is _SLOT or isinstance(tree, torch.Tensor):
        out.append(grads)
    elif isinstance(tree, (tuple, list)):
        for v, g in zip(tree, grads):
            _grads_at_tensors(v, g, out)
    return out


def refuse_grad(what: str, *args, hint: str = "") -> None:
    """Raise when a kernel is called with grad mode on and an input that
    requires grad: the raw wrappers have no backward, and an output
    without one would drop the gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in _tensors(args, [])):
        raise ValueError(f"{what}: an input requires grad, but this kernel "
                         f"call has no backward{'; ' + hint if hint else ''}")


class _KernelCall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *tensors):
        kernel_fn, plain_fn, adjoint_fn, args, name = spec
        with trace.span("kernel." + name):
            out = kernel_fn(*_rebuild(args, iter(tensors)))
        ctx.spec = spec
        ctx.single = isinstance(out, torch.Tensor)
        ctx.save_for_backward(*tensors)
        return out if ctx.single else tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        kernel_fn, plain_fn, adjoint_fn, args, name = ctx.spec
        with trace.span("backward." + name):
            tensors = ctx.saved_tensors
            need = ctx.needs_input_grad[1:]
            if adjoint_fn is not None and not on_cpu(tensors[0], "backward"):
                res = adjoint_fn(_rebuild(args, iter(tensors)), *grads)
                got = _grads_at_tensors(args, res, [])
                return (None,) + tuple(g if n else None
                                       for g, n in zip(got, need))
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(bool(n))
                          for t, n in zip(tensors, need)]
                out = plain_fn(*_rebuild(args, iter(leaves)))
                outs = (out,) if ctx.single else tuple(out)
                pairs = [(o, g) for o, g in zip(outs, grads)
                         if g is not None and o is not None
                         and o.requires_grad]
                wrt = [x for x in leaves if x.requires_grad]
                got = [None] * len(wrt)
                if pairs and wrt:
                    got = list(torch.autograd.grad(
                        [o for o, _ in pairs], wrt, [g for _, g in pairs],
                        allow_unused=True))
            it = iter(got)
            return (None,) + tuple(next(it) if x.requires_grad else None
                                   for x in leaves)


def with_adjoint(kernel_fn, plain_fn, adjoint_fn, *args, name=None):
    """``kernel_fn(*args)`` (a tensor or a flat tuple of tensors and
    Nones) as one autograd node. Its backward on CUDA tensors is
    ``adjoint_fn(args, *output_grads)``, which returns a structure
    parallel to ``args`` with a gradient or None at each tensor; on CPU
    tensors, or with ``adjoint_fn`` None, it is the gradient of
    ``plain_fn(*args)`` (same outputs) recomputed from the saved inputs.
    Output gradients the loss does not reach arrive as zeros. ``name``
    (default ``kernel_fn``'s) names the node's trace spans,
    ``kernel.<name>`` and ``backward.<name>``."""
    tensors = _tensors(args, [])
    return _KernelCall.apply(
        (kernel_fn, plain_fn, adjoint_fn, _template(args),
         name or kernel_fn.__name__), *tensors)


def with_twin_grad(kernel_fn, plain_fn, *args, name=None):
    """``kernel_fn(*args)`` with the gradient of its plain twin
    ``plain_fn`` on both devices (the JAX package's ``with_xla_grad``)."""
    return with_adjoint(kernel_fn, plain_fn, None, *args, name=name)
