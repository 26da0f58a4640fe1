"""pint_tpu_torch stands alone: no jax, no pint_tpu, no quiet CPU fallback.

* No file of ``pint_tpu_torch/``, nor ``chip_smoke.py``, imports ``jax`` or
  ``pint_tpu`` (an AST scan of every import statement, every kernel
  wrapper among them).
* A fresh interpreter loads par/tim, forms residuals and runs the chi2
  grid, whole and in checkpointed chunks, with the port on the CPU, and
  ends with no ``jax`` and no ``pint_tpu`` module loaded; others
  simulate, write and fit the DD set
  (``WLSFitter.fit_toas``) and the GLS set with its noise model
  (``GLSFitter.fit_toas``) the same way, and form the committed young
  set's residuals (glitches, PiecewiseSpindown, WAVE, IFUNC, PHOFF),
  and one runs the analysis modules (polycos, orbital phase, binary
  conversion, model selection, derived quantities, Phase).
* Without a CUDA device, every entry point called without ``device``
  raises instead of running on the CPU.
* ``chip_smoke.py`` fails without a card, and in a directory that holds
  nothing else of the repository, and never prints its ``"ok"`` line.
"""

import ast
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import torch_port_data as data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pint_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _sources():
    out = [SMOKE]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pint_tpu")


def test_no_jax_or_reference_imports():
    bad = []
    files = _sources()
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    print(f"scanned {len(files)} files")
    assert len(files) > 30
    # every kernel wrapper, the fused phase chain's included
    for mod in ("qs_phase", "kepler", "delay_chain", "phase_chain"):
        assert os.path.join(PKG, "kernels", f"{mod}.py") in files, mod
    # the simulators, the random models, the chunked scan and its runtime
    for mod in ("examples", "simulation", "gridutils", "runtime",
                "faultinject"):
        assert os.path.join(PKG, f"{mod}.py") in files, mod
    # the last five components
    for mod in ("glitch", "piecewise", "wave", "ifunc", "phase_offset"):
        assert os.path.join(PKG, "models", f"{mod}.py") in files, mod
    assert not bad, bad


_CHILD = r"""
import os, sys, warnings
import numpy as np
sys.path.insert(0, {repo!r})
from pint_tpu_torch import faultinject, runtime, simulation
from pint_tpu_torch.examples import j0740_realistic_par
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.gridutils import grid_chisq_flat
from pint_tpu_torch.models import get_model
from pint_tpu_torch.toa import get_TOAs
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(j0740_realistic_par(dmx_bins=8).splitlines())
    toas = get_TOAs({tim!r}, model=model)
model.M2.frozen = True
model.SINI.frozen = True
fitter = WLSFitter(toas, model, device="cpu")
r = fitter.resids.time_resids
chi2 = grid_chisq_flat(fitter, {{"M2": np.array([0.25]),
                                 "SINI": np.array([0.99])}}, maxiter=1)
assert np.all(np.isfinite(r)) and np.all(np.isfinite(chi2))
# the chunked, checkpointed form of the same grid, and its checkpoint
ck = os.path.join({tmp!r}, "grid.npz")
chunked = grid_chisq_flat(fitter, {{"M2": np.array([0.25]),
                                    "SINI": np.array([0.99])}}, maxiter=1,
                          chunk_size=1, checkpoint=ck)
assert np.array_equal(chunked, chi2) and "results" in runtime.load_checkpoint(ck)
assert not faultinject.is_active("chunk_raise")
simulation.update_fake_toa_errors(toas, 1.0)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu"))
print("LEAKED", leaked)
"""


_CHILD_DD = r"""
import os, sys, warnings
import numpy as np
sys.path.insert(0, {repo!r})
from pint_tpu_torch.examples import dd_realistic_par, simulate_dd_realistic
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.toa import get_TOAs, write_tim
_, toas = simulate_dd_realistic(ntoas=60, dmx_bins=4, device="cpu")
tim = os.path.join({tmp!r}, "dd.tim")
write_tim(tim, toas)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(dd_realistic_par(dmx_bins=4).splitlines())
    toas = get_TOAs(tim, model=model)
    model.PB.value += 1e-7
    chi2 = WLSFitter(toas, model, device="cpu").fit_toas(maxiter=2)
assert np.isfinite(chi2) and model.CHI2.value is not None
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu"))
print("LEAKED", leaked)
"""


_CHILD_GLS = r"""
import os, sys, warnings
import numpy as np
sys.path.insert(0, {repo!r})
from pint_tpu_torch.examples import (dd_noise_realistic_par,
                                     simulate_dd_noise_realistic)
from pint_tpu_torch.fitter import GLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.toa import get_TOAs, write_tim
_, toas = simulate_dd_noise_realistic(ntoas=48, dmx_bins=4, device="cpu")
tim = os.path.join({tmp!r}, "gls.tim")
write_tim(tim, toas)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(dd_noise_realistic_par(dmx_bins=4).splitlines())
    toas = get_TOAs(tim, model=model)
    model.PB.value += 1e-7
    fitter = GLSFitter(toas, model, device="cpu")
    chi2 = fitter.fit_toas(maxiter=2)
assert np.isfinite(chi2) and set(fitter.noise_resids) == {{
    "EcorrNoise", "PLRedNoise"}}
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu"))
print("LEAKED", leaked)
"""


_CHILD_YOUNG = r"""
import os, sys, warnings
import numpy as np
sys.path.insert(0, {repo!r})
from pint_tpu_torch.examples import young_par
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import get_TOAs
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(young_par().splitlines())
    toas = get_TOAs({tim!r}, model=model)
r = Residuals(toas, model, device="cpu").time_resids
assert np.all(np.isfinite(r)) and np.std(r) < 1e-5
assert {{"Glitch", "PiecewiseSpindown", "Wave", "IFunc",
         "PhaseOffset"}} <= set(model.components)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu"))
print("LEAKED", leaked)
"""


_CHILD_ANALYSIS = r"""
import os, sys, warnings
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from pint_tpu_torch import derived_quantities, modelselect, phase
from pint_tpu_torch.binaryconvert import convert_binary
from pint_tpu_torch.examples import j0740_realistic_par
from pint_tpu_torch.models import get_model
from pint_tpu_torch.polycos import Polycos
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import get_TOAs
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(j0740_realistic_par(dmx_bins=8).splitlines())
    toas = get_TOAs({tim!r}, model=model)
    pcs = Polycos.generate_polycos(model, 55000.0, 55000.0 + 1 / 24,
                                   ncoeff=8, nsamples=16, device="cpu")
    dd = convert_binary(model, "DD")
r = Residuals(toas, model, device="cpu")
orb = model.orbital_phase(r.pdict, r.batch)
assert bool(torch.all((orb >= 0) & (orb < 1)))
assert len(pcs.entries) == 1 and dd.BINARY.value == "DD"
assert np.isfinite(modelselect.akaike_information_criterion(
    model, toas, device="cpu"))
assert model.components["AstrometryEquatorial"].radec_deg()[0] > 0
assert derived_quantities.mass_funct(4.77, 3.98) > 0
assert float(phase.from_float(torch.tensor(2.75)).frac) == -0.25
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu"))
print("LEAKED", leaked)
"""


def _run_child(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LEAKED []" in res.stdout, res.stdout


def test_port_runs_without_jax_loaded(tmp_path):
    _run_child(_CHILD.format(repo=REPO, tim=data.REF_TIM, tmp=str(tmp_path)))


def test_dd_fit_runs_without_jax_loaded(tmp_path):
    _run_child(_CHILD_DD.format(repo=REPO, tmp=str(tmp_path)))


def test_gls_fit_runs_without_jax_loaded(tmp_path):
    _run_child(_CHILD_GLS.format(repo=REPO, tmp=str(tmp_path)))


def test_young_set_runs_without_jax_loaded():
    _run_child(_CHILD_YOUNG.format(repo=REPO, tim=data.YOUNG_REF_TIM))


def test_analysis_modules_run_without_jax_loaded():
    """Polycos, orbital phase, binary conversion, model selection, the
    derived quantities and Phase in a fresh interpreter on the CPU."""
    _run_child(_CHILD_ANALYSIS.format(repo=REPO, tim=data.REF_TIM))


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from pint_tpu_torch.convert import pdict_from_numpy
    from pint_tpu_torch.examples import (j0740_realistic_par,
                                         simulate_dd_noise_realistic,
                                         simulate_j0740_class,
                                         simulate_young_realistic)
    from pint_tpu_torch import modelselect
    from pint_tpu_torch.fitter import GLSFitter, WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import (add_correlated_noise,
                                           make_fake_toas_fromtim)
    from pint_tpu_torch.toa import get_TOAs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(j0740_realistic_par(dmx_bins=8).splitlines())
        toas = get_TOAs(data.REF_TIM, model=model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gmodel = get_model(data.dd_gls_par_lines())
        gtoas = get_TOAs(data.GLS_REF_TIM, model=gmodel)
    calls = [lambda: toas.to_batch(),
             lambda: model.build_pdict(toas),
             lambda: model.attach_tzr(toas),
             lambda: Residuals(toas, model),
             lambda: WLSFitter(toas, model),
             lambda: GLSFitter(gtoas, gmodel),
             lambda: add_correlated_noise(gtoas, gmodel, seed=0),
             lambda: simulate_dd_noise_realistic(ntoas=8, dmx_bins=2),
             lambda: simulate_j0740_class(ntoas=8),
             lambda: simulate_young_realistic(ntoas=8),
             lambda: make_fake_toas_fromtim(data.REF_TIM, model),
             lambda: pdict_from_numpy({"const": {"F0": np.float64(1.0)}}),
             lambda: Polycos.generate_polycos(model, 55000.0, 55000.04,
                                              ncoeff=4, nsamples=8),
             lambda: modelselect.akaike_information_criterion(model, toas),
             lambda: modelselect.bayesian_information_criterion(model,
                                                                toas)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device"):
            call()
    # the same calls run when the CPU is asked for
    assert Residuals(toas, model, device="cpu").batch.device.type == "cpu"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = SMOKE
    cwd = REPO
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=cwd, env=env)
    print(f"{where}: exit {res.returncode}: {res.stderr.strip()[-200:]}")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
