"""LightRidge-DSE: analytical-model design space exploration (paper §4).

A copy of ``repro.core.dse`` (numpy throughout; the port imports nothing
of the JAX package).  Its emulators are the caller's: on the port they are
built on ``repro_torch.core.models.emulate_batch`` (the card) or on
sequential ``build_model(cfg).apply`` calls.

The paper trains a gradient-boosted regression model on (wavelength, unit
size, distance) -> accuracy grids from two wavelengths and transfers it to
a nearby third, replacing a 121-point grid search with a few verification
emulations (~60x fewer).  sklearn is unavailable offline, so the GBDT
(least-squares boosting over depth-limited regression trees, the paper's
n_estimators/learning_rate/max_depth hyperparameters) is implemented here
from scratch in numpy.

Beyond paper: ``ShardingDSE`` reuses the same engine over the roofline
analytical model to rank distributed-layout candidates for the LM stack
(DESIGN.md §5 note (b)).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


# --------------------------------------------------------------- trees ---
@dataclasses.dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0


def _fit_tree(X: np.ndarray, y: np.ndarray, depth: int, min_leaf: int = 2):
    node = _Node(value=float(np.mean(y)))
    if depth == 0 or len(y) < 2 * min_leaf or np.allclose(y, y[0]):
        return node
    best = (0.0, None, None)  # (gain, feature, thresh)
    base = np.sum((y - y.mean()) ** 2)
    for f in range(X.shape[1]):
        order = np.argsort(X[:, f])
        xs, ys = X[order, f], y[order]
        csum = np.cumsum(ys)
        csq = np.cumsum(ys * ys)
        n = len(ys)
        for i in range(min_leaf, n - min_leaf):
            if xs[i] == xs[i - 1]:
                continue
            nl, nr = i, n - i
            sl, sr = csum[i - 1], csum[-1] - csum[i - 1]
            ql, qr = csq[i - 1], csq[-1] - csq[i - 1]
            sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
            gain = base - sse
            if gain > best[0]:
                best = (gain, f, 0.5 * (xs[i] + xs[i - 1]))
    if best[1] is None:
        return node
    _, f, t = best
    mask = X[:, f] <= t
    node.feature, node.thresh = f, t
    node.left = _fit_tree(X[mask], y[mask], depth - 1, min_leaf)
    node.right = _fit_tree(X[~mask], y[~mask], depth - 1, min_leaf)
    return node


def _predict_tree(node: _Node, X: np.ndarray) -> np.ndarray:
    if node.left is None:
        return np.full(len(X), node.value)
    mask = X[:, node.feature] <= node.thresh
    out = np.empty(len(X))
    out[mask] = _predict_tree(node.left, X[mask])
    out[~mask] = _predict_tree(node.right, X[~mask])
    return out


class GradientBoostingRegressor:
    """Least-squares GBDT (paper: n_estimators=3500, lr=0.2, max_depth=3)."""

    def __init__(self, n_estimators: int = 3500, learning_rate: float = 0.2,
                 max_depth: int = 3, random_state: int = 25,
                 subsample: float = 1.0):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.random_state = random_state
        self.subsample = subsample
        self.trees: list = []
        self.base: float = 0.0

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.random_state)
        self.base = float(np.mean(y))
        resid = y - self.base
        self.trees = []
        for _ in range(self.n_estimators):
            if self.subsample < 1.0:
                idx = rng.random(len(y)) < self.subsample
                if idx.sum() < 4:
                    idx = np.ones(len(y), bool)
            else:
                idx = np.ones(len(y), bool)
            tree = _fit_tree(X[idx], resid[idx], self.max_depth)
            pred = _predict_tree(tree, X)
            resid = resid - self.learning_rate * pred
            self.trees.append(tree)
            if np.max(np.abs(resid)) < 1e-8:
                break
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        out = np.full(len(X), self.base)
        for tree in self.trees:
            out += self.learning_rate * _predict_tree(tree, X)
        return out


# ---------------------------------------------------------- DONN DSE -----
@dataclasses.dataclass
class DSEResult:
    best_point: dict
    predicted_acc: float
    verified_acc: float
    emulations_used: int
    grid_size: int

    @property
    def speedup(self) -> float:
        return self.grid_size / max(self.emulations_used, 1)


class LightRidgeDSE:
    """Analytical-model DSE over (wavelength, unit_size, distance).

    train with grids from reference wavelengths, predict the landscape at a
    new nearby wavelength, verify only the top-k candidates by emulation.
    Validity: the analytical model only transfers within the same spectral
    neighbourhood (maximum half-cone diffraction angle theory [5]) — the
    engine refuses extrapolation beyond ``max_wavelength_ratio``.
    """

    def __init__(self, n_estimators: int = 400, learning_rate: float = 0.2,
                 max_depth: int = 3, max_wavelength_ratio: float = 1.6):
        self.model = GradientBoostingRegressor(
            n_estimators, learning_rate, max_depth
        )
        self.max_wavelength_ratio = max_wavelength_ratio
        self._lams: list = []

    @staticmethod
    def _features(lam, d, D, depth=None):
        # physics-aware features: raw + the Fresnel-number-ish couplings;
        # optional ragged-depth axis for architecture-depth exploration
        base = [lam * 1e9, d * 1e6, D, d / lam, d * d / (lam * D)]
        if depth is not None:
            base.append(float(depth))
        return base

    def fit(self, points: Sequence[tuple], accs: Sequence[float]):
        """points: iterable of (wavelength, unit_size, distance[, depth]).

        All points must share one arity — either the classic 3-tuple grid
        or the depth-extended 4-tuple grid (mixed arities would silently
        misalign the feature matrix).
        """
        if len({len(p) for p in points}) > 1:
            raise ValueError("mix of 3- and 4-tuple DSE points")
        X = np.array([self._features(*p) for p in points])
        self.model.fit(X, np.asarray(accs))
        self._lams = sorted({p[0] for p in points})
        return self

    def predict(self, points: Sequence[tuple]) -> np.ndarray:
        lams = {p[0] for p in points}
        for lam in lams:
            ratio = max(lam / self._lams[0], self._lams[-1] / lam)
            if ratio > self.max_wavelength_ratio:
                raise ValueError(
                    f"wavelength {lam} outside the validity neighbourhood "
                    f"of the training data (theory-violating extrapolation)"
                )
        X = np.array([self._features(*p) for p in points])
        return self.model.predict(X)

    def explore(self, lam: float, candidates: Sequence[tuple],
                emulate: Optional[Callable[[tuple], float]] = None,
                top_k: int = 2, *,
                emulate_batch: Optional[Callable] = None) -> DSEResult:
        """Predict the landscape at ``lam``; emulate only the top_k points.

        candidates: (unit_size, distance) pairs, or — for architecture
        exploration over ragged stack depths — (unit_size, distance,
        depth) triples.  Verification runs through ``emulate`` (one point
        -> one score, called top_k times) or — preferred —
        ``emulate_batch`` (all top_k points -> scores in one call, e.g.
        built on ``repro_torch.core.models.emulate_batch`` so the
        candidates share one batched pass instead of K model builds and
        runs; with depth-extended candidates the shared pass depth-pads +
        masks the shallower stacks).
        """
        if emulate is None and emulate_batch is None:
            raise ValueError("explore needs emulate or emulate_batch")
        pts = [(lam,) + tuple(c) for c in candidates]
        preds = self.predict(pts)
        order = np.argsort(-preds)[:top_k]
        if emulate_batch is not None:
            accs = list(emulate_batch([pts[i] for i in order]))
            if len(accs) != len(order):
                raise ValueError(
                    f"emulate_batch returned {len(accs)} scores for "
                    f"{len(order)} candidates"
                )
        else:
            accs = [emulate(pts[i]) for i in order]
        best_acc, best_pt, best_pred = -1.0, None, 0.0
        for i, acc in zip(order, accs):
            if acc > best_acc:
                best_acc, best_pt, best_pred = acc, pts[i], preds[i]
        best_point = {"wavelength": best_pt[0], "unit_size": best_pt[1],
                      "distance": best_pt[2]}
        if len(best_pt) > 3:
            best_point["depth"] = best_pt[3]
        return DSEResult(
            best_point=best_point,
            predicted_acc=float(best_pred),
            verified_acc=float(best_acc),
            emulations_used=int(top_k),
            grid_size=len(candidates),
        )


def sensitivity_analysis(emulate: Optional[Callable[[tuple], float]],
                         best: tuple,
                         deltas=(-0.10, -0.05, 0.0, 0.05, 0.10),
                         emulate_batch: Optional[Callable] = None) -> dict:
    """Single-parameter control-variable tests (paper Table 3).

    With ``emulate_batch`` every delta point of every parameter is scored
    in one batched call (3 * len(deltas) candidates share one pass)
    instead of one sequential emulation per point.
    """
    if emulate is None and emulate_batch is None:
        raise ValueError("sensitivity_analysis needs emulate or emulate_batch")
    lam, d, D = best
    params = (("wavelength", 0), ("unit_size", 1), ("distance", 2))
    pts = []
    for _, idx in params:
        for delta in deltas:
            p = [lam, d, D]
            p[idx] = p[idx] * (1.0 + delta)
            pts.append(tuple(p))
    if emulate_batch is not None:
        accs = list(emulate_batch(pts))
        if len(accs) != len(pts):
            raise ValueError(
                f"emulate_batch returned {len(accs)} scores for "
                f"{len(pts)} points"
            )
    else:
        accs = [emulate(p) for p in pts]
    out = {}
    k = len(deltas)
    for j, (name, _) in enumerate(params):
        out[name] = [(delta, accs[j * k + i])
                     for i, delta in enumerate(deltas)]
    return out


# ------------------------------------------------ sharding DSE (beyond) --
@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    name: str
    rules: dict
    accum_steps: int = 1


def rank_layouts(records: Sequence[dict]) -> list:
    """Rank dry-run records (one per layout candidate) by the roofline
    bound max(compute, memory, collective); ties broken by collective."""
    def key(r):
        t = r["terms"]
        return (max(t.values()), t["collective_s"])

    return sorted(records, key=key)
