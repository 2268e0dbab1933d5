"""Vehtari-2021 diagnostics vs analytically known processes.

For a stationary AR(1) process x_t = phi x_{t-1} + e_t the integrated
autocorrelation time is (1+phi)/(1-phi), so ESS/N -> (1-phi)/(1+phi); rank
normalization is a monotone map so a Gaussian AR(1) keeps (approximately) its
autocorrelation structure.  R-hat of identically distributed chains -> 1;
chains with shifted means must be flagged.
"""

import numpy as np
from scipy.signal import lfilter

from hmcmt2d.sampler import diagnostics as D


def _ar1(phi, N, C, P, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((N, C, P))
    x = lfilter([1.0], [1.0, -phi], e, axis=0)
    return x[N // 5:]  # drop transient


def test_ess_matches_ar1_theory():
    for phi in (0.0, 0.5, 0.8):
        x = _ar1(phi, 25000, 4, 3, seed=int(phi * 10) + 1)
        N, C, _ = x.shape
        expected = (1 - phi) / (1 + phi)
        est = np.asarray(D.ess(x)) / (N * C)
        # ESS estimates carry MC noise; 20% relative is tight enough to
        # distinguish phi=0 (1.0) / 0.5 (0.33) / 0.8 (0.11)
        assert np.all(np.abs(est - expected) < 0.2 * max(expected, 0.05)), (
            phi, est, expected)


def test_rhat_stationary_vs_shifted():
    x = _ar1(0.3, 8000, 4, 2, seed=5)
    r = np.asarray(D.split_rhat(x))
    assert np.all(r < 1.02), r
    # shift one chain's mean by 2 sd -> must be flagged well above 1.05
    y = x.copy()
    y[:, 0, :] += 2.0 * x.std()
    r2 = np.asarray(D.split_rhat(y))
    assert np.all(r2 > 1.1), r2


def test_rhat_flags_tail_difference():
    # equal means/variances but one chain with inflated tails: the folded
    # (tail) statistic must catch what the bulk statistic alone misses
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6000, 4, 1))
    x[:, 0, 0] = rng.standard_t(df=1.5, size=6000)
    x[:, 0, 0] /= x[:, 0, 0].std()
    r = np.asarray(D.split_rhat(x))
    assert np.all(r > 1.01), r


def test_ess_handles_mh_ties():
    # MH-style duplicated draws (rejections): average ranks keep the
    # estimator sane -- ESS must drop roughly with the duplication factor
    x = _ar1(0.0, 4000, 4, 2, seed=11)
    dup = np.repeat(x[::2], 2, axis=0)
    N, C, _ = dup.shape
    est = np.asarray(D.ess(dup)) / (N * C)
    assert np.all(est < 0.75), est
    assert np.all(est > 0.3), est


def test_ess_tail_runs():
    x = _ar1(0.5, 10000, 4, 2, seed=3)
    N, C, _ = x.shape
    t = np.asarray(D.ess_tail(x))
    assert t.shape == (2,)
    assert np.all(t > 0.02 * N * C), t
    assert np.all(t < 1.5 * N * C), t


def test_short_inputs_do_not_crash():
    """S<4 inputs used to IndexError inside the Geyer pair array; they must
    return a defined (tau=1) answer through the public API instead."""
    x = _ar1(0.5, 3, 2, 2, seed=0)
    e = np.asarray(D.ess(x))
    assert e.shape == (2,)
    assert np.all(np.isfinite(e)) and np.all(e > 0)
    t = np.asarray(D.ess_tail(x))
    assert np.all(np.isfinite(t))
