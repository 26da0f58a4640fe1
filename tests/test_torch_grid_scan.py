"""pint_tpu_torch's chunked, checkpointed chi2 grid against pint_tpu's.

On the committed 200-TOA J0740-class set (``tests/data/j0740_sim_200.tim``)
the stored 3 x 3 M2/SINI grid at ``maxiter=2``, with the port on the CPU
in chunks of 2 points (5 chunks, the last padded by repeating its point):

* chi2 within 1e-6 relative of pint_tpu's stored grid
  (``j0740_sim_200_grid_chi2.json``) and of the port's whole-grid
  program (the bar ``gridutils.build_grid_fit_fn`` asserts between its
  paths);
* a SIGTERM after chunk 1 raises ``ScanInterrupted`` and leaves a
  checkpoint; ``resume=True`` gives chi2 bit-identical to the
  uninterrupted chunked scan, its first two chunks restored;
* a chunk that raises beyond ``max_retries`` is rerouted through the
  unbatched fit per point, within 1e-6 relative;
* ``_slice_stacked`` pads a short chunk with its last point.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu_torch import faultinject
from pint_tpu_torch.exceptions import ScanInterrupted
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.gridutils import (_slice_stacked, grid_chisq_flat,
                                      stack_grid_pdict)
from pint_tpu_torch.runtime import ChunkStatus

CHI2_TOL = 1e-6
CHUNK = 2


@pytest.fixture(scope="module")
def scan():
    """The port's fitter on the committed set, pint_tpu's stored grid, and
    the port's whole-grid and chunked chi2 on it."""
    with open(data.REF_JSON) as f:
        ref = json.load(f)
    model, toas = data.load_torch(data.REF_TIM, grid=True)
    fitter = WLSFitter(toas, model, device="cpu")
    grid = {k: np.asarray(v) for k, v in ref["grid"].items()}
    whole = grid_chisq_flat(fitter, grid, maxiter=ref["maxiter"])
    chunked, summary = grid_chisq_flat(
        fitter, grid, maxiter=ref["maxiter"], chunk_size=CHUNK,
        return_summary=True)
    return dict(ref=ref, fitter=fitter, grid=grid, whole=whole,
                chunked=chunked, summary=summary)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_chunked_matches_pint_tpu_and_whole_grid(scan):
    ref, s = scan["ref"], scan["summary"]
    want = np.asarray(ref["chi2"])
    assert scan["fitter"].fit_params == ref["fit_params"]
    assert (s.n_chunks, s.chunk_size) == (5, CHUNK)
    assert s.counts() == {"OK": 5}
    gap_ref = _rel(scan["chunked"], want)
    gap_whole = _rel(scan["chunked"], scan["whole"])
    assert gap_ref <= CHI2_TOL, f"vs pint_tpu {gap_ref:.3e} (bar 1e-6)"
    assert gap_whole <= CHI2_TOL, f"vs whole grid {gap_whole:.3e} (bar 1e-6)"


def test_sigterm_then_resume_is_bit_identical(scan, tmp_path):
    ck = str(tmp_path / "grid.npz")
    kw = dict(maxiter=scan["ref"]["maxiter"], chunk_size=CHUNK,
              checkpoint=ck)
    with faultinject.sigterm_midscan(after_chunk=1):
        with pytest.raises(ScanInterrupted) as ei:
            grid_chisq_flat(scan["fitter"], scan["grid"], **kw)
    assert (ei.value.chunks_done, ei.value.n_chunks) == (2, 5)
    assert os.path.exists(ck)
    chi2, s = grid_chisq_flat(scan["fitter"], scan["grid"], resume=True,
                              return_summary=True, **kw)
    assert s.resumed_chunks == 2 and s.counts() == {"OK": 5}
    np.testing.assert_array_equal(chi2, scan["chunked"],
                                  err_msg="resume not bit-identical")


def test_raising_chunk_is_rerouted(scan):
    with faultinject.chunk_raise(chunks=(1,), times=99):
        chi2, s = grid_chisq_flat(
            scan["fitter"], scan["grid"], maxiter=scan["ref"]["maxiter"],
            chunk_size=CHUNK, max_retries=1, return_summary=True)
    assert s.statuses[1] == ChunkStatus.REROUTED
    assert s.counts() == {"OK": 4, "REROUTED": 1}
    assert s.retries == 1 and s.reroutes == 1
    gap = _rel(chi2, scan["chunked"])
    assert gap <= CHI2_TOL, f"rerouted chunk {gap:.3e} (bar 1e-6)"


def test_slice_stacked_pads_with_the_last_point(scan):
    f, grid = scan["fitter"], scan["grid"]
    stacked = stack_grid_pdict(f.model, f.resids.pdict, grid)
    last = _slice_stacked(stacked, list(grid), 8, 9, CHUNK)
    for k in grid:
        v = last["delta"][k]
        assert v.shape == (CHUNK,) and torch.equal(v[0], v[1]), k
        assert torch.equal(v[0], stacked["delta"][k][8]), k
    point = _slice_stacked(stacked, list(grid), 3, 4, None)
    assert all(point["delta"][k].shape == () for k in grid)
    assert point["delta"]["F0"] is stacked["delta"]["F0"]
