"""Converters from :mod:`pint_tpu`'s data to the port's.

Both take plain numpy leaves (``jax.tree.map(np.asarray, tree)`` of a
:mod:`pint_tpu` params dict, or a :class:`pint_tpu.toabatch.TOABatch`'s
``_asdict()`` likewise) and return the port's tensors on ``device`` with
the same dtypes, leaf for leaf: the noise model's leaves too (the basis
blocks, the Fourier frequencies, the int32 ECORR column maps).  The port builds both itself from par/tim
files as well (:meth:`pint_tpu_torch.models.timing_model.TimingModel.build_pdict`,
:meth:`pint_tpu_torch.toa.TOAs.to_batch`); the tests hold each against the
converted :mod:`pint_tpu` one.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.toabatch import TOABatch
from pint_tpu_torch.utils import resolve_device


def _leaf(v, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), device=dev)


def pdict_from_numpy(tree: dict, device=None) -> dict:
    """A params dict (nested dicts of numpy arrays / scalars) as nested
    dicts of tensors on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(tree)


def batch_from_numpy(columns: dict, device=None) -> TOABatch:
    """A :class:`TOABatch` from its columns by name (numpy arrays; the
    planet positions as a dict of arrays) on ``device``."""
    dev = resolve_device(device)
    return TOABatch(**{
        k: ({p: _leaf(a, dev) for p, a in v.items()} if isinstance(v, dict)
            else _leaf(v, dev))
        for k, v in columns.items()})
