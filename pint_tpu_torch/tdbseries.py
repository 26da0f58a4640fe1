"""TDB - TT analytic series (Fairhead & Bretagnon 1990).

The reference obtains TDB through astropy/ERFA (`Observatory.get_TDBs`,
reference `src/pint/observatory/__init__.py:443`), whose ``dtdb`` routine
evaluates the full 787-term FB90 harmonic expansion.  Neither astropy nor any
ephemeris/series data file ships in this environment, so this module carries
the dominant terms of the same published series transcribed from the
literature (amplitudes ≥ ~0.03 µs), giving geocentric TDB-TT good to a few
hundred ns worst-case over 1970–2060.  MEASURED against tempo2's own
golden tt2tb/tt2tdb columns (tests/test_tdb_parity.py): the full
pipeline (this series + the topocentric term + exact two-part
arithmetic) agrees to 63-66 ns median / ~250 ns max over 2002-2011 —
two orders below the builtin ephemeris's accuracy floor.  The residual
~70 ns per-TOA scatter is not harmonically modelable from the available
truth (holdout-validated; see the test module docstring), so no
empirical correction ships.  If a fuller coefficient table is
available on disk (``PINT_TPU_TDB_COEFFS`` pointing at an ``.npz`` with
arrays ``amp/freq/phase`` per order), it is loaded instead and accuracy
becomes ~ns.

Form: TDB-TT [s] = Σ_j t^j Σ_i A_ij sin(ω_ij t + φ_ij), with t in Julian
millennia (TT) from J2000.0, A in seconds, ω in rad/millennium.

Pure numpy, host-side: TDB computation is loader work (reference
`src/pint/toa.py:2262`) and must run on true-IEEE CPU floats (the TPU
backend's emulated f64 is not correctly rounded).
"""

from __future__ import annotations

import os

import numpy as np

# --- built-in truncated FB90 coefficient table --------------------------------
# columns: amplitude [µs], frequency [rad/millennium], phase [rad]
_T0 = np.array(
    [
        (1656.674564, 6283.075849991, 6.240054195),
        (22.417471, 5753.384884897, 4.296977442),
        (13.839792, 12566.151699983, 6.196904410),
        (4.770086, 529.690965095, 0.444401603),
        (4.676740, 6069.776754553, 4.021195093),
        (2.256707, 213.299095438, 5.543113262),
        (1.694205, -3.523118349, 5.025132748),
        (1.554905, 77713.771467920, 5.198467090),
        (1.276839, 7860.419392439, 5.988822341),
        (1.193379, 5223.693919802, 3.649823730),
        (1.115322, 3930.209696220, 1.422745069),
        (0.794185, 11506.769769794, 2.322313077),
        (0.600309, 1577.343542448, 2.678271909),
        (0.496817, 6208.294251424, 5.696701824),
        (0.486306, 5884.926846583, 0.520007179),
        (0.468597, 6244.942814354, 5.866398759),
        (0.447061, 26.298319800, 3.615796498),
        (0.435206, -398.149003408, 4.349338347),
        (0.432392, 74.781598567, 2.435898309),
        (0.375510, 5507.553238667, 4.103476804),
        (0.243085, -775.522611324, 3.651837925),
        (0.230685, 5856.477659115, 4.773852582),
        (0.203747, 12036.460734888, 4.333987818),
        (0.173435, 18849.227549974, 6.153743485),
        (0.159080, 10977.078804699, 1.890075226),
        (0.143935, -796.298006816, 5.957517795),
        (0.137927, 11790.629088659, 1.135934669),
        (0.119979, 38.133035638, 4.551585768),
        (0.118971, 5486.777843175, 1.914547226),
        (0.116120, 1059.381930189, 0.873504123),
        (0.101868, -5573.142801634, 5.984503847),
        (0.098358, 2544.314419883, 0.092793886),
        (0.080164, 206.185548437, 2.095377709),
        (0.079645, 4694.002954708, 2.949233637),
        (0.075019, 2942.463423292, 4.980931759),
        (0.064397, 5746.271337896, 1.280308748),
        (0.063814, 5760.498431898, 4.167901731),
        (0.062617, 20.775395492, 2.654394814),
        (0.058844, 426.598190876, 4.839650148),
        (0.054139, 17260.154654690, 3.411091093),
        (0.048373, 155.420399434, 2.251573730),
        (0.048042, 2146.165416475, 1.495846011),
        (0.046551, -0.980321068, 0.921573539),
        (0.042732, 632.783739313, 5.720622217),
        (0.042560, 161000.685737473, 1.270837679),
        (0.042411, 5092.151958115, 1.589072916),
        (0.040759, 12352.852604545, 3.981496998),
        (0.040480, 15720.838784878, 2.546610123),
        (0.040184, -7.113547001, 3.565975565),
        (0.036955, 3154.687084896, 5.071801441),
        (0.036564, 5088.628839767, 3.324679049),
        (0.036507, 801.820931124, 6.248866009),
        (0.034867, 522.577418094, 5.210064075),
        (0.033529, 9437.762934887, 2.404714239),
        (0.033477, 6062.663207553, 4.144987272),
        (0.032438, 6076.890301554, 0.749317412),
        (0.032423, 8827.390269875, 5.541473556),
        (0.030215, 7084.896781115, 3.389610345),
    ],
    dtype=np.float64,
)

_T1 = np.array(
    [
        (102.156724, 6283.075849991, 4.249032005),
        (1.706576, 12566.151699983, 1.205744032),
        (0.269668, 213.299095438, 3.400290479),
        (0.265919, 529.690965095, 5.836047367),
        (0.210568, -3.523118349, 6.262738348),
        (0.077996, 5223.693919802, 4.670344204),
        (0.059146, 26.298319800, 1.083044735),
        (0.054764, 77713.771467920, 6.222874454),
        (0.034420, -398.149003408, 5.980077351),
        (0.033595, 5507.553238667, 5.980162321),
        (0.032088, 18849.227549974, 4.162913471),
        (0.029198, 5856.477659115, 0.623811863),
        (0.027764, 155.420399434, 3.745318113),
        (0.025190, 5746.271337896, 2.980330535),
        (0.024976, 5760.498431898, 2.467913690),
        (0.022997, -796.298006816, 1.174411803),
        (0.021774, 206.185548437, 3.854787540),
        (0.017925, -775.522611324, 1.092065955),
        (0.013794, 426.598190876, 2.699831988),
        (0.013276, 6062.663207553, 5.845801920),
        (0.012869, 6076.890301554, 5.333425680),
        (0.012152, 1059.381930189, 6.222874454),
        (0.011774, 12036.460734888, 2.292832062),
        (0.011081, -7.113547001, 5.154724984),
        (0.010143, 4694.002954708, 4.044013795),
        (0.010084, 522.577418094, 0.749320262),
        (0.009357, 5486.777843175, 3.416081409),
    ],
    dtype=np.float64,
)

_T2 = np.array(
    [
        (4.322990, 6283.075849991, 2.642893748),
        (0.406495, 0.0, 4.712388980),
        (0.122605, 12566.151699983, 2.438140634),
        (0.019476, 213.299095438, 1.642186981),
        (0.016916, 529.690965095, 4.510959344),
        (0.013374, -3.523118349, 1.502210314),
    ],
    dtype=np.float64,
)

_T3 = np.array(
    [
        (0.143388, 6283.075849991, 1.131453581),
        (0.006671, 12566.151699983, 0.775148593),
    ],
    dtype=np.float64,
)


def _load_tables():
    path = os.environ.get("PINT_TPU_TDB_COEFFS", "")
    if path and os.path.exists(path):
        z = np.load(path)
        out = []
        for j in range(4):
            if f"amp{j}" in z:
                out.append(
                    np.stack([z[f"amp{j}"], z[f"freq{j}"], z[f"phase{j}"]], axis=1)
                )
            else:
                out.append(np.zeros((0, 3)))
        return out
    return [_T0, _T1, _T2, _T3]


_TABLES = [np.asarray(t) for t in _load_tables()]


def tdb_minus_tt(t_millennia) -> np.ndarray:
    """TDB - TT in seconds at TT epoch t (Julian millennia from J2000)."""
    t = np.asarray(t_millennia, np.float64)[..., None]
    total = np.zeros(np.shape(t)[:-1], np.float64)
    tpow = np.ones_like(t)
    for tab in _TABLES:
        if tab.shape[0]:
            amp, freq, phase = tab[:, 0], tab[:, 1], tab[:, 2]
            total = total + (tpow * amp * np.sin(freq * t + phase)).sum(-1) * 1e-6
        tpow = tpow * t
    return total


def tdb_minus_tt_topo(obs_pos_m, earth_vel_m_s) -> np.ndarray:
    """Topocentric correction to TDB-TT: (v_earth · r_obs)/c² [s].

    ``obs_pos_m``: observatory position wrt geocenter (GCRS) [m];
    ``earth_vel_m_s``: barycentric velocity of the geocenter [m/s].
    Amplitude ~2 µs·sin(diurnal).  The reference gets this from ERFA dtdb's
    topocentric terms when an observatory location is attached to the
    astropy Time.
    """
    c = 299792458.0
    return np.sum(obs_pos_m * earth_vel_m_s, axis=-1) / c**2
