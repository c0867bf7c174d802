"""Two-component Gaussian mixture by EM, as softcluster ``gmm`` fits it.

The reference clusters with ``sklearn.mixture.GaussianMixture(
n_components=2, random_state=0).fit(X).predict_proba(X)``; the port does
not depend on scikit-learn, so this module computes the same function in
numpy and scipy, step by step as scikit-learn does (float64 throughout,
the reference's accuracies are float64):

1. KMeans(n_clusters=2, n_init=1) on X centred by its column means, its
   tolerance ``1e-4 * mean(var(X, axis=0))``: k-means++ seeding from the
   mixture's ``RandomState(0)`` (the first centre by ``choice``, then
   ``2 + int(log 2)`` candidates drawn by ``uniform`` against the cumulative
   squared distances, the one that lowers the potential most kept), then
   Lloyd iterations (labels by the first least ``|c|^2 - 2 x.c``, centres as
   ordered sums times 1 / weight, an empty cluster relocated to the farthest
   point, centres of an empty cluster put on the heaviest one) until the
   labels repeat or the centres move by at most the tolerance, and a last
   labelling where the labels did not repeat;
2. one-hot responsibilities from those labels, the weights, means and full
   covariances (``reg_covar`` 1e-6 on the diagonal) and the Cholesky factors
   of the precisions;
3. EM until the mean log-likelihood changes by less than ``tol`` 1e-3, at
   most 100 iterations;
4. ``predict_proba``: the responsibilities of the fitted mixture.

scikit-learn's ``fit`` ends with an e-step that sets no parameter (it
only makes ``fit_predict``'s labels agree with ``predict``), so
``predict_proba`` needs nothing from it and ``fit`` here leaves it out.
``tests/test_torch_gmm.py`` holds ``predict_proba`` and the means to
scikit-learn's within 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg

N_COMPONENTS = 2
REG_COVAR = 1e-6
TOL = 1e-3
MAX_ITER = 100
KMEANS_TOL = 1e-4
KMEANS_MAX_ITER = 300


def _row_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances(a: np.ndarray, x: np.ndarray, x_norms: np.ndarray):
    """Squared distances of rows ``a`` to rows ``x``, clipped at 0:
    ``-2 a.x + |a|^2 + |x|^2`` in that order."""
    d = -2 * (a @ x.T)
    d += _row_norms(a)[:, None]
    d += x_norms[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(x: np.ndarray, x_norms: np.ndarray, k: int,
                     rng: np.random.RandomState) -> np.ndarray:
    n = x.shape[0]
    w = np.ones(n)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    first = rng.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, None], x, x_norms)
    pot = closest @ w
    for c in range(1, k):
        rand = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(x[cand], x, x_norms)
        np.minimum(closest, dist, out=dist)
        pots = dist @ w.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot = pots[best]
        closest = dist[best]
        centers[c] = x[cand[best]]
    return centers


def _lloyd_step(x: np.ndarray, centers: np.ndarray, update: bool = True):
    """One Lloyd iteration: ``(labels, new centres, centre shifts)``."""
    k, d = centers.shape
    dist = np.empty((x.shape[0], k))
    dist[:] = _row_norms(centers)[None, :]
    dist += -2.0 * (x @ centers.T)
    labels = np.zeros(x.shape[0], dtype=np.int32)
    for i in range(x.shape[0]):          # the first least distance wins
        best = dist[i, 0]
        for j in range(1, k):
            if dist[i, j] < best:
                best, labels[i] = dist[i, j], j
    if not update:
        return labels, centers, None
    new = np.zeros_like(centers)
    weight = np.zeros(k)
    for i in range(x.shape[0]):
        weight[labels[i]] += 1.0
        new[labels[i]] += x[i] * 1.0
    empty = np.where(weight == 0)[0]
    if empty.size:
        far_d = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(far_d, -empty.size)[:-empty.size - 1:-1]
        if np.max(far_d) != 0:
            for idx, j in enumerate(empty):
                f = far[idx]
                old = labels[f]
                new[old] -= x[f] * 1.0
                new[j] = x[f] * 1.0
                weight[j] = 1.0
                weight[old] -= 1.0
    heaviest = int(np.argmax(weight))
    for j in range(k):
        if weight[j] > 0:
            new[j] *= 1.0 / weight[j]
        else:
            new[j] = new[heaviest]
    shift = np.array([_shift(new[j], centers[j]) for j in range(k)])
    return labels, new, shift


def _shift(a: np.ndarray, b: np.ndarray) -> float:
    """Euclidean distance, summed four coordinates at a time."""
    n4, rem = divmod(a.size, 4)
    result = 0.0
    for i in range(n4):
        q = a[4 * i:4 * i + 4] - b[4 * i:4 * i + 4]
        result += ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]
    for i in range(rem):
        q = a[4 * n4 + i] - b[4 * n4 + i]
        result += q * q
    return math.sqrt(result)


def kmeans_labels(x: np.ndarray, k: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """KMeans(n_clusters=k, n_init=1)'s labels, seeded from ``rng``."""
    tol = np.mean(np.var(x, axis=0)) * KMEANS_TOL
    x = x - x.mean(axis=0)
    centers = _kmeans_plusplus(x, _row_norms(x), k, rng)
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        labels, new, shift = _lloyd_step(x, centers)
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _lloyd_step(x, centers, update=False)[0]
    return labels


def _logsumexp(a: np.ndarray) -> np.ndarray:
    """log(sum(exp(a), axis=1)) as scikit-learn's ``_logsumexp`` forms it."""
    amax = np.max(a, axis=1, keepdims=True)
    at_max = a == amax
    a = a.copy()
    a[at_max] = -np.inf
    m = np.sum(at_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(amax), amax, 0)
    s = np.sum(np.exp(a - shift), axis=1, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + amax, axis=1)


class GaussianMixture:
    """The fitted two-component mixture: ``weights_ [2]``, ``means_ [2,
    d]``, ``covariances_ [2, d, d]``, ``precisions_cholesky_ [2, d, d]``."""

    def __init__(self) -> None:
        self.weights_ = self.means_ = None
        self.covariances_ = self.precisions_cholesky_ = None
        self.n_iter_ = 0
        self.converged_ = False

    # -- the m-step's pieces ---------------------------------------------
    def _estimate(self, x: np.ndarray, resp: np.ndarray):
        nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
        means = (resp.T @ x) / nk[:, None]
        d = x.shape[1]
        cov = np.empty((N_COMPONENTS, d, d))
        for k in range(N_COMPONENTS):
            diff = x - means[k, :]
            cov[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
            cov[k].flat[:d * d:d + 1] += REG_COVAR
        chol = np.empty_like(cov)
        for k in range(N_COMPONENTS):
            try:
                c = scipy.linalg.cholesky(cov[k], lower=True)
            except np.linalg.LinAlgError as err:
                raise ValueError(
                    "gmm: a component's covariance is not positive "
                    "definite") from err
            chol[k] = scipy.linalg.solve_triangular(c, np.eye(d),
                                                    lower=True).T
        return nk, means, cov, chol

    def _weighted_log_prob(self, x: np.ndarray) -> np.ndarray:
        n, d = x.shape
        chol = self.precisions_cholesky_
        log_det = np.sum(np.log(chol.reshape(N_COMPONENTS, -1)[:, ::d + 1]),
                         axis=1)
        log_prob = np.empty((n, N_COMPONENTS))
        for k in range(N_COMPONENTS):
            y = (x @ chol[k]) - (self.means_[k] @ chol[k])
            log_prob[:, k] = np.sum(np.square(y), axis=1)
        log_prob = -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det
        return log_prob + np.log(self.weights_)

    def _log_resp(self, x: np.ndarray):
        wlp = self._weighted_log_prob(x)
        norm = _logsumexp(wlp)
        with np.errstate(under="ignore"):
            return norm, wlp - norm[:, None]

    # -- the estimator -----------------------------------------------------
    def fit(self, x: np.ndarray) -> "GaussianMixture":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[0] < N_COMPONENTS:
            raise ValueError(f"gmm needs at least {N_COMPONENTS} rows of "
                             f"features, got shape {x.shape}")
        rng = np.random.RandomState(0)
        resp = np.zeros((x.shape[0], N_COMPONENTS))
        resp[np.arange(x.shape[0]), kmeans_labels(x, N_COMPONENTS, rng)] = 1
        nk, self.means_, self.covariances_, self.precisions_cholesky_ = \
            self._estimate(x, resp)
        self.weights_ = nk / x.shape[0]
        lower = -np.inf
        for it in range(1, MAX_ITER + 1):
            prev = lower
            norm, log_resp = self._log_resp(x)
            nk, self.means_, self.covariances_, self.precisions_cholesky_ = \
                self._estimate(x, np.exp(log_resp))
            self.weights_ = nk / np.sum(nk)
            lower = np.mean(norm)
            self.n_iter_ = it
            if abs(lower - prev) < TOL:
                self.converged_ = True
                break
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return np.exp(self._log_resp(np.asarray(x, dtype=np.float64))[1])
