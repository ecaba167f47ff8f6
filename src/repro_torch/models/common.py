"""Shared model helpers: the scan chunk length, parameter init, the dense
projection and the f32-or-wider dtype.

Every parameter carries JAX's logical axes (``repro/models/common.py``'s
``Param(value, axes)``) as its ``axes`` attribute, set where it is made
(:func:`with_axes`); ``DecoderLM.param_axes()`` collects them and the
sharding rules read them."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..sharding.tensor_parallel import Split

#: a split read of a weight: (the split, the weight's dim, its whole size)
SplitRead = Tuple[Optional[Split], int, int]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the f32 islands (norms, softmax, GOOM operands, the
    loss): f32, or f64 for f64 inputs (the one-process float64 yardstick)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in :func:`wide_dtype`."""
    return x.to(wide_dtype(x.dtype))


def chunk_len(s: int, chunk: int) -> int:
    """Largest divisor of ``s`` that is <= ``chunk``.

    The goom layer's time-invariant A multiplies every step, so there is no
    identity element to pad with: a scan of length ``s`` runs as ``s // L``
    chunks of length L.  L sets the in-chunk reassociation, so it must be
    the JAX package's choice exactly.  Prime ``s`` > ``chunk`` degrades to
    L=1 (sequential, slow but right)."""
    L = min(chunk, s)
    while s % L:
        L -= 1
    return L


def dense_apply(w: torch.Tensor, x: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = None,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., o1, o2, ...] = x[..., i] @ w[i, o1, o2, ...] (+ b[o1, o2, ...])
    in ``compute_dtype`` (default: x's dtype)."""
    cd = compute_dtype or x.dtype
    out_dims = w.shape[1:]
    y = torch.matmul(x.to(cd), w.to(cd).reshape(w.shape[0], -1))
    y = y.reshape(x.shape[:-1] + out_dims)
    return y if b is None else y + b.to(cd)


Axes = Tuple[Optional[str], ...]


def with_axes(t: torch.Tensor, axes: Sequence[Optional[str]]) -> nn.Parameter:
    """``t`` as a parameter with JAX's logical ``axes``, one name (or None) a dim."""
    if len(axes) != t.ndim:
        raise ValueError(f"axes {tuple(axes)} for a parameter of shape {tuple(t.shape)}")
    p = t if isinstance(t, nn.Parameter) else nn.Parameter(t)
    p.axes = tuple(axes)
    return p


def normal_param(shape, std: float, *, axes: Sequence[Optional[str]], device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None
                 ) -> nn.Parameter:
    """A parameter drawn from N(0, std²), scaled in place (no second copy:
    the port builds multi-GiB expert weights this way)."""
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return with_axes(w.mul_(std), axes)


class Dense(nn.Module):
    """Weight ``w`` of shape (in_dim, *out_dims), the JAX package's layout;
    initialised LeCun-normal (std 1/sqrt(in_dim), or ``std``) from
    ``generator``; with ``bias``, a zero bias ``b`` of shape out_dims.  Its
    logical axes are ``(in_axis, *out_axes)``, the bias's ``out_axes``
    (JAX's ``dense_init`` defaults).  Its in and out sizes are those of the
    weight it is handed: a split module's block (``split``)."""

    def __init__(self, in_dim: int, out_dims, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 std: Optional[float] = None, bias: bool = False,
                 in_axis: Optional[str] = "embed",
                 out_axes: Sequence[Optional[str]] = ("mlp",)):
        super().__init__()
        self.w = normal_param((in_dim, *out_dims),
                              in_dim ** -0.5 if std is None else std,
                              axes=(in_axis, *out_axes),
                              device=device, dtype=dtype, generator=generator)
        self.b = (with_axes(torch.zeros(tuple(out_dims), device=device, dtype=dtype),
                            out_axes) if bias else None)

    def forward(self, x: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None,
                split: Optional[SplitRead] = None) -> torch.Tensor:
        """``split=(sp, dim, n)``: the rank's block of the weight's ``dim``
        (``n`` whole; the bias's block alike), handed whole or as the
        block; ``sp`` None reads the whole."""
        w, b = self.w, self.b
        if split is not None and split[0] is not None:
            sp, dim, n = split
            w = sp.take(w, dim, n)
            if b is not None:
                if dim == 0:
                    raise ValueError("a Dense split on its input dim has no bias to split")
                b = sp.take(b, dim - 1, n)
        return dense_apply(w, x, compute_dtype=compute_dtype, b=b)
