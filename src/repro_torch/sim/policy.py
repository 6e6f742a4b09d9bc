"""Learned page-placement policy: a small GMM over reuse features.

The ``hotness`` placement promotes an entry after a fixed number of
restores (``TierConfig.hot_promote_after``) — a threshold heuristic that
cannot tell a burst of restores from a sustained hot working set, and
never un-learns. ICGMM-style classifiers (GMM over reuse-distance /
recency features, PAPERS.md arXiv:2408.05614) beat such thresholds for
exactly this hot/cold decision, cheaply enough to sit on the restore
path. :class:`LearnedPlacement` is that classifier: it fits a
two-component diagonal-covariance Gaussian mixture (plain numpy EM, no
new dependencies) over per-entry features

    - reuse distance (simulated ns between consecutive restores)
    - restore recency (simulated ns since the previous restore)
    - restore frequency (decayed restore count)
    - entry bytes

and scores entries by the posterior probability of the short-reuse
component. ``CxlTier`` consumes it as ``placement="learned"`` (promotion
= ``is_hot``, demotion victims = lowest ``score``); ``ShardedTier``
reuses the same observation stream to re-home hot shared prefixes onto
the rank that restores them most (see ``core.sharded_tier``).

Everything is deterministic: fixed EM iteration count, deterministic
median-split initialisation, no RNG — two runs over the same trace fit
identical mixtures, which the differential replay gates rely on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

# EM fit hyper-parameters. Fixed, not configurable knobs: the policy is
# judged end-to-end by the placement bench gates, and a deterministic
# fit schedule keeps replay bit-stable.
_EM_ITERS = 8                 # fixed EM iteration budget per refit
_VAR_FLOOR = 1e-3             # diagonal covariance floor (log-space feats)
_COMPONENTS = 2               # hot / cold


@dataclasses.dataclass
class _EntryState:
    """Incremental per-key reuse statistics feeding the feature vector."""

    last_ns: float = 0.0      # simulated time of the latest restore
    gap_ns: float = 0.0       # latest inter-restore gap (reuse distance)
    count: float = 0.0        # decayed restore count (frequency)
    count_t: float = 0.0      # timestamp the decayed count is valid at
    nbytes: int = 0           # latest observed entry payload


def _features(gap_ns: float, recency_ns: float, count: float,
              nbytes: int) -> List[float]:
    """Log-compressed feature vector — reuse distances span 1e2..1e9 ns,
    so the mixture is fit in log space where both scales are Gaussian-ish."""
    return [math.log1p(max(gap_ns, 0.0)),
            math.log1p(max(recency_ns, 0.0)),
            math.log1p(max(count, 0.0)),
            math.log1p(max(float(nbytes), 0.0))]


class LearnedPlacement:
    """Hot/cold classifier over restore-reuse features (numpy EM GMM).

    ``observe`` records one restore of ``key`` at simulated time
    ``now_ns``; every ``refit_every`` observations (once ``min_fit``
    samples exist) the mixture is refit over a sliding window of recent
    feature vectors. ``score`` returns the posterior probability that
    the key's *current* features (reuse estimate replaced by its live
    recency) belong to the short-reuse component; ``is_hot`` thresholds
    it. Below ``min_fit`` samples the policy falls back to the counter
    heuristic (``fallback_after`` decayed restores), so cold-start
    behaviour matches the ``hotness`` policy it replaces.

    ``half_life_ns > 0`` ages the per-key restore counts (satellite of
    the same aging applied to the counter policy): a once-hot entry's
    frequency feature decays toward zero while its recency feature
    grows, so the mixture stops classifying it hot without any explicit
    eviction rule.
    """

    def __init__(self, *, window: int = 512, refit_every: int = 32,
                 min_fit: int = 16, hot_threshold: float = 0.5,
                 fallback_after: int = 2, half_life_ns: float = 0.0):
        if window < min_fit:
            raise ValueError(f"window ({window}) must hold at least "
                             f"min_fit ({min_fit}) samples")
        self.window = int(window)
        self.refit_every = int(refit_every)
        self.min_fit = int(min_fit)
        self.hot_threshold = float(hot_threshold)
        self.fallback_after = int(fallback_after)
        self.half_life_ns = float(half_life_ns)
        self._state: Dict[object, _EntryState] = {}
        self._samples: List[List[float]] = []   # sliding feature window
        self._since_fit = 0
        self._obs = 0
        # fitted mixture (None until the first successful fit)
        self._means: Optional[np.ndarray] = None      # (K, F)
        self._vars: Optional[np.ndarray] = None       # (K, F)
        self._weights: Optional[np.ndarray] = None    # (K,)
        self._hot_comp = 0
        self.fits = 0                                  # telemetry

    # ------------------------------------------------------------- decay
    def _decayed_count(self, st: _EntryState, now_ns: float) -> float:
        """Restore count aged by the configured half-life (0 = frozen)."""
        if self.half_life_ns <= 0.0 or st.count <= 0.0:
            return st.count
        dt = max(0.0, now_ns - st.count_t)
        return st.count * 0.5 ** (dt / self.half_life_ns)

    # ----------------------------------------------------------- observe
    def observe(self, key, now_ns: float, nbytes: int) -> None:
        """Record one restore of ``key`` at simulated time ``now_ns``."""
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _EntryState()
            st.last_ns = float(now_ns)
            st.count = 1.0
            st.count_t = float(now_ns)
            st.nbytes = int(nbytes)
            return                    # first sighting: no reuse gap yet
        gap = max(0.0, float(now_ns) - st.last_ns)
        st.count = self._decayed_count(st, float(now_ns)) + 1.0
        st.count_t = float(now_ns)
        st.gap_ns = gap
        st.last_ns = float(now_ns)
        st.nbytes = int(nbytes)
        self._samples.append(_features(gap, gap, st.count, st.nbytes))
        if len(self._samples) > self.window:
            del self._samples[: len(self._samples) - self.window]
        self._obs += 1
        self._since_fit += 1
        if (self._since_fit >= self.refit_every
                and len(self._samples) >= self.min_fit):
            self._fit()
            self._since_fit = 0

    def forget(self, key) -> None:
        """Drop ``key``'s state (freed / lost entries)."""
        self._state.pop(key, None)

    # --------------------------------------------------------------- fit
    def _fit(self) -> None:
        """Deterministic EM over the sample window (diagonal Gaussians).

        Initialised by a median split on the reuse-distance feature —
        component 0 seeds on short-reuse samples — then a fixed
        ``_EM_ITERS`` rounds of EM with floored variances. The hot
        component is whichever ends with the smaller mean reuse
        distance."""
        x = np.asarray(self._samples, np.float64)        # (N, F)
        n, f = x.shape
        med = float(np.median(x[:, 0]))
        resp = np.zeros((n, _COMPONENTS), np.float64)
        lo = x[:, 0] <= med
        resp[lo, 0] = 1.0
        resp[~lo, 1] = 1.0
        if not lo.any() or lo.all():      # degenerate: one-point spread
            return                        # keep the previous fit (if any)
        means = np.zeros((_COMPONENTS, f))
        var = np.ones((_COMPONENTS, f))
        w = np.full(_COMPONENTS, 1.0 / _COMPONENTS)
        for _ in range(_EM_ITERS):
            # M step
            nk = resp.sum(axis=0) + 1e-12
            means = (resp.T @ x) / nk[:, None]
            diff = x[None, :, :] - means[:, None, :]     # (K, N, F)
            var = np.maximum(
                (resp.T[:, :, None] * diff ** 2).sum(axis=1) / nk[:, None],
                _VAR_FLOOR)
            w = nk / n
            # E step (log-domain, diagonal Gaussians)
            ll = (-0.5 * ((diff ** 2) / var[:, None, :]
                          + np.log(2.0 * np.pi * var[:, None, :]))
                  ).sum(axis=2).T + np.log(w)[None, :]   # (N, K)
            ll -= ll.max(axis=1, keepdims=True)
            resp = np.exp(ll)
            resp /= resp.sum(axis=1, keepdims=True)
        self._means, self._vars, self._weights = means, var, w
        self._hot_comp = int(np.argmin(means[:, 0]))    # short reuse = hot
        self.fits += 1

    # ------------------------------------------------------------- score
    def _posterior(self, feats: List[float]) -> float:
        x = np.asarray(feats, np.float64)
        diff = x[None, :] - self._means                  # (K, F)
        # Monotone extension on the reuse features (gap, recency): a key
        # reusing *faster* than the hot cluster's mean is at least as
        # hot, and one reusing *slower* than the cold cluster's mean is
        # at least as cold. Without the clamp a tightly-fit hot
        # component (variance at the floor) rejects gaps shorter than
        # its own mean, scoring the hottest keys cold.
        cold_comp = 1 - self._hot_comp
        diff[self._hot_comp, :2] = np.maximum(diff[self._hot_comp, :2], 0.0)
        diff[cold_comp, :2] = np.minimum(diff[cold_comp, :2], 0.0)
        ll = (-0.5 * (diff ** 2 / self._vars
                      + np.log(2.0 * np.pi * self._vars))).sum(axis=1) \
            + np.log(self._weights)
        ll -= ll.max()
        p = np.exp(ll)
        return float(p[self._hot_comp] / p.sum())

    def score(self, key, now_ns: float) -> float:
        """P(hot) for ``key`` at ``now_ns`` — 0.0 for unseen keys.

        The reuse-distance feature is the larger of the last observed
        gap and the live recency: an entry that has gone quiet scores as
        if its next gap were at least that long, so scores decay as
        simulated time passes (no restore required)."""
        st = self._state.get(key)
        if st is None:
            return 0.0
        recency = max(0.0, float(now_ns) - st.last_ns)
        count = self._decayed_count(st, float(now_ns))
        if self._means is None:
            # cold start: mirror the counter heuristic on decayed counts
            return 1.0 if count >= self.fallback_after else 0.0
        gap = max(st.gap_ns, recency)
        return self._posterior(_features(gap, recency, count, st.nbytes))

    def is_hot(self, key, now_ns: float) -> bool:
        """Promotion verdict: posterior P(hot) over ``hot_threshold``."""
        return self.score(key, now_ns) >= self.hot_threshold

    @property
    def fitted(self) -> bool:
        """True once a mixture has been fit (past cold-start fallback)."""
        return self._means is not None
