"""pint_tpu_torch's host stack vs pint_tpu, on one small simulated J0740 set.

The port's ``get_TOAs``/``get_model`` (carried copies of pint_tpu's numpy
host modules) load the same par string and tim file as pint_tpu's:

* every ``TOABatch`` column is bit-equal to pint_tpu's;
* every params-dict leaf (``const``/``delta``/``mask``) is bit-equal, and
  the TZR reference phase ``__tzrphase__`` — computed by the port's own
  phase chain — agrees to 1e-12 cycles;
* ``pdict_from_numpy``/``batch_from_numpy`` of pint_tpu's objects give the
  port's own, leaf for leaf.
"""

import numpy as np
import pytest
import torch

import torch_port_data as data
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.convert import batch_from_numpy, pdict_from_numpy
from pint_tpu_torch.residuals import Residuals as TResiduals

TZR_TOL_CYCLES = 1e-12


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tim = data.sim_tim(tmp_path_factory)
    jm, jt = data.load_jax(tim)
    tm, tt = data.load_torch(tim)
    return dict(jr=JResiduals(jt, jm), tr=TResiduals(tt, tm, device="cpu"),
                jm=jm, tm=tm, jt=jt, tt=tt)


def _columns(batch):
    cols = batch._asdict() if hasattr(batch, "_asdict") else batch.columns()
    out = {}
    for k, v in cols.items():
        if isinstance(v, dict):
            out.update({f"{k}.{p}": v[p] for p in v})
        else:
            out[k] = v
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def _assert_bits_equal(a: np.ndarray, b: np.ndarray, what: str):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                  np.atleast_1d(b).view(np.uint8),
                                  err_msg=what)


def test_toabatch_columns_bit_equal(both):
    """The TOABatch columns, planet positions included: same dtype,
    shape and bits."""
    j, t = _columns(both["jr"].batch), _columns(both["tr"].batch)
    assert set(j) == set(t)
    for k in j:
        _assert_bits_equal(j[k], t[k], k)
    print(f"TOABatch: {len(j)} columns bit-equal over "
          f"{both['tr'].batch.ntoas} TOAs")


def _leaves(p):
    return {(grp, k): (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
            for grp in ("const", "delta", "mask") for k, v in p[grp].items()}


def _tzr_gap(a: np.ndarray, b: np.ndarray) -> float:
    """|a - b| of two quad-single word vectors, summed in float64
    (w0 - w0' exactly first, then the lower words)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    return abs((a64[0] - b64[0]) + (a64[1:] - b64[1:]).sum())


#: mask leaves only the port builds: the delay kernel's DMX bin index
#: and DelayJump bits (kernels/delay_chain.py)
KERNEL_ONLY = {("mask", "__dmxidx__"), ("mask", "__delayjumpbits__")}


def test_pdict_leaves_bit_equal(both):
    """Every const/delta/mask leaf bit-equal; __tzrphase__ within 1e-12
    cycles (bit-equal words expected: same f32 op order).  The port's
    dict also carries the delay kernel's own per-TOA index leaves."""
    j, t = _leaves(both["jr"].pdict), _leaves(both["tr"].pdict)
    assert set(j) == set(t) - KERNEL_ONLY
    tzr = ("const", "__tzrphase__")
    for k in j:
        if k != tzr:
            _assert_bits_equal(j[k], t[k], str(k))
    gap = _tzr_gap(j[tzr], t[tzr])
    print(f"pdict: {len(j)} leaves; __tzrphase__ gap {gap:.3e} cycles "
          f"(words bit-equal: {np.array_equal(j[tzr], t[tzr])})")
    assert gap <= TZR_TOL_CYCLES


def test_converters_match_port_builds(both):
    """pdict_from_numpy / batch_from_numpy of pint_tpu's objects equal the
    port's own builds (pint_tpu's __tzrphase__ rides along unchanged)."""
    jp = data.tree_numpy(both["jr"].pdict)
    conv = _leaves(pdict_from_numpy(jp, device="cpu"))
    own = _leaves(both["tr"].pdict)
    for k, v in conv.items():
        if k == ("const", "__tzrphase__"):
            assert _tzr_gap(v, own[k]) <= TZR_TOL_CYCLES
        else:
            _assert_bits_equal(v, own[k], str(k))
    jb = both["jr"].batch._asdict()
    cols = {k: (data.tree_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in jb.items()}
    conv_b = _columns(batch_from_numpy(cols, device="cpu"))
    own_b = _columns(both["tr"].batch)
    for k in own_b:
        _assert_bits_equal(conv_b[k], own_b[k], k)


def test_model_structure_matches(both):
    """Same components, free parameters and linear/nonlinear split."""
    jm, tm = both["jm"], both["tm"]
    assert list(jm.components) == list(tm.components)
    assert jm.free_params == tm.free_params
    assert jm.partition_linear_params(jm.free_params) == \
        tm.partition_linear_params(tm.free_params)
    assert both["jt"].ntoas == both["tt"].ntoas == data.NTOAS


def test_batch_padding_and_concatenation(both):
    """pad_batch_to / concatenate / select give pint_tpu's columns."""
    from pint_tpu import toabatch as jtb
    from pint_tpu_torch import toabatch as ttb

    jb, tb = both["jr"].batch, both["tr"].batch
    n = jb.ntoas
    idx = np.arange(0, n, 3)
    for jx, tx in ((jtb.pad_batch_to(jb, n + 7), ttb.pad_batch_to(tb, n + 7)),
                   (jtb.concatenate([jb, jb]), ttb.concatenate([tb, tb])),
                   (jb.select(idx), tb.select(idx))):
        j, t = _columns(jx), _columns(tx)
        assert set(j) == set(t)
        for k in j:
            _assert_bits_equal(j[k], t[k], k)
    with pytest.raises(ValueError):
        ttb.pad_batch_to(tb, n - 1)


def test_free_vector_round_trip(both):
    """x0 / with_x map the free vector onto the delta leaves and back."""
    tm, p = both["tm"], both["tr"].pdict
    names = tm.free_params
    x = torch.arange(1, len(names) + 1, dtype=torch.float64) * 1e-12
    p2 = tm.with_x(p, x, names)
    assert torch.equal(tm.x0(p2, names), x)
    assert torch.equal(tm.x0(p, names), torch.zeros_like(x))
    assert p2["const"] is p["const"] and p2["delta"] is not p["delta"]


@pytest.mark.parametrize("policy", ["mask", "warn", "raise"])
def test_make_batch_validation_policies(policy):
    """Non-finite / nonpositive uncertainties and non-finite epochs: the
    same rows kept, the same columns, or the same refusal."""
    import warnings

    from pint_tpu import toabatch as jtb
    from pint_tpu_torch import toabatch as ttb

    rng = np.random.default_rng(7)
    n = 12
    kw = dict(tdb_day=rng.integers(55000, 56000, n),
              tdb_frac=rng.uniform(-0.5, 0.5, n),
              error_us=rng.uniform(0.5, 2.0, n),
              freq_mhz=np.full(n, 1400.0))
    kw["error_us"][[2, 5]] = [np.nan, -1.0]
    kw["tdb_frac"][8] = np.inf
    if policy == "raise":
        with pytest.raises(Exception) as je:
            jtb.make_batch(policy=policy, **kw)
        with pytest.raises(Exception) as te:
            ttb.make_batch(policy=policy, device="cpu", **kw)
        assert type(je.value).__name__ == type(te.value).__name__
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = _columns(jtb.make_batch(policy=policy, **kw))
        t = _columns(ttb.make_batch(policy=policy, device="cpu", **kw))
    assert set(j) == set(t)
    for k in j:
        _assert_bits_equal(j[k], t[k], k)
    print(f"{policy}: {len(t['error_us'])} of {n} rows")
