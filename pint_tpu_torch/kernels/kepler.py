"""Wrapper of the ``kepler_E`` CUDA kernel (``csrc/kepler.cu``).

:func:`kepler_E_op` solves Kepler's equation E - e sin E = M for every
element in one launch.  Tensors on a CUDA device launch the kernel (or
raise); tensors on the CPU run its plain version,
:func:`pint_tpu_torch.models.binary_orbits.kepler_E`.  There is no
fallback from one to the other.

:class:`KeplerE` makes it a differentiable operation for ``torch.func``
and for reverse mode, with pint_tpu's implicit-function rule
(:func:`pint_tpu.models.binary_orbits._kepler_E_jvp`)

    d E = (d M + sin E · d e) / (1 - e_c cos E)

(e_c the clipped e, ``d e`` passed through unmasked), so no derivative
goes through the Newton iteration.  Its ``vmap`` rule folds batched
lanes into the kernel's element axis, so ``torch.func.vmap`` over a grid
or a ``jacfwd`` still makes one launch per primal evaluation.

``KeplerE.launches`` counts kernel launches (plain runs do not count).
"""

from __future__ import annotations

import ctypes

import torch

from pint_tpu_torch.models.binary_orbits import UNIT_MAX, kepler_E

F64 = torch.float64

_c_void_p, _c_int64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    from pint_tpu_torch.kernels.build import load

    lib = load("kepler")
    if getattr(lib, "_argtypes_set", False):
        return lib
    lib.kepler_E.argtypes = [_c_void_p] * 3 + [_c_int64, _c_void_p]
    lib.kepler_E.restype = ctypes.c_int
    lib.kepler_error_string.argtypes = [ctypes.c_int]
    lib.kepler_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def _launch(M, e):
    """Run the CUDA kernel on ``M`` and ``e`` broadcast to one shape."""
    if e.device != M.device:
        raise ValueError(f"kepler_E: inputs on {M.device} and {e.device}")
    shape = torch.broadcast_shapes(M.shape, e.shape)
    M = M.expand(shape).contiguous()
    e = e.expand(shape).contiguous()
    E = torch.empty(shape, dtype=F64, device=M.device)
    if E.numel() == 0:
        return E
    stream = torch.cuda.current_stream(M.device).cuda_stream
    err = _lib().kepler_E(M.data_ptr(), e.data_ptr(), E.data_ptr(),
                          E.numel(), stream)
    if err != 0:
        raise RuntimeError("kepler_E launch failed: "
                           + _lib().kepler_error_string(err).decode())
    KeplerE.launches += 1
    return E


def run(M, e):
    """E(M, e): the kernel on CUDA tensors, the plain version on CPU
    tensors, and an error on anything else."""
    for t in (M, e):
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(
                "kepler_E: an input is still wrapped by a torch.func "
                "transform; pass every tensor through KeplerE.apply")
    if M.dtype != F64 or e.dtype != F64:
        raise ValueError("kepler_E: M and e must be float64")
    if M.is_cuda:
        return _launch(M, e)
    if M.device.type == "cpu":
        return kepler_E(M, e)
    raise ValueError(f"kepler_E: unsupported device {M.device}")


def _factors(E, e):
    """(1 / (1 - e_c cos E), sin E): the two factors of the tangent."""
    ec = torch.clamp(e, 0.0, UNIT_MAX)
    return 1.0 / (1.0 - ec * torch.cos(E)), torch.sin(E)


def _sum_to(g, shape):
    """Reduce a broadcast gradient back to an input's shape."""
    if g.shape == shape:
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class KeplerE(torch.autograd.Function):
    """``(M, e) -> E`` with pint_tpu's implicit-function derivative, in
    forward mode (``jvp``) and reverse mode (``backward``)."""

    #: kernel launches in this process (plain CPU runs are not counted)
    launches = 0

    @staticmethod
    def forward(M, e):
        return run(M, e)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, e = inputs
        ctx.shapes = (M.shape, e.shape)
        ctx.save_for_forward(output, e)
        ctx.save_for_backward(output, e)

    @staticmethod
    def jvp(ctx, dM, de):
        E, e = ctx.saved_tensors
        inv, sinE = _factors(E, e)
        out = torch.zeros_like(E)
        if dM is not None:
            out = out + dM
        if de is not None:
            out = out + sinE * de
        return out * inv

    @staticmethod
    def backward(ctx, gE):
        E, e = ctx.saved_tensors
        inv, sinE = _factors(E, e)
        g = gE * inv
        return _sum_to(g, ctx.shapes[0]), _sum_to(g * sinE, ctx.shapes[1])

    @staticmethod
    def vmap(info, in_dims, M, e):
        B = info.batch_size
        front = [x.expand(B, *x.shape) if d is None else x.movedim(d, 0)
                 for x, d in zip((M, e), in_dims)]
        # a common trailing shape, the batch axis leading
        shape = torch.broadcast_shapes(front[0].shape[1:], front[1].shape[1:])
        front = [x.reshape(B, *[1] * (len(shape) - x.dim() + 1),
                           *x.shape[1:]).expand(B, *shape) for x in front]
        return KeplerE.apply(*front), 0


def kepler_E_op(M, e):
    """The eccentric anomaly E(M, e) [rad]: the ``kepler_E`` kernel on CUDA
    tensors, its plain version on CPU tensors, differentiable by the
    implicit-function rule.  ``M`` and ``e`` are float64 (a tensor of
    another dtype is refused, not converted); ``e`` may be a Python
    scalar or broadcast against ``M``."""
    if not isinstance(e, torch.Tensor):
        e = torch.tensor(e, dtype=F64, device=M.device)
    return KeplerE.apply(M, e)
