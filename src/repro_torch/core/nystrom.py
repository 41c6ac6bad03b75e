"""Nystrom-approximated kernel SVM: port of ``repro/core/nystrom.py``.

With m landmarks, K_mm their Gram and k_m(x) the cross-Gram row, the
feature map phi(x) = K_mm^{-1/2} k_m(x) gives phi(x).phi(x') ~ k(x, x'),
and the kernel SVM (paper Eq. 12) becomes exactly the linear PEMSVM on phi
with the prior lam^{-1} I (the paper's Sec 4.3 question, answered in the
reference's docstring). ``NystromSVM`` therefore delegates to a LIN
``PEMSVM`` with ``config.phi_spec`` set: both drivers work, and the
statistic featurizes raw rows on the device
(``ops.nystrom_fused_stats``), so the (N, m) phi never exists on the
main route. The default is m = ceil(sqrt(N)) landmarks.

Host work is one-time: the landmark choice and the K_mm^{-1/2}
eigendecomposition (float64, with a spectral floor), cached on the model.

The delegate carries the task: KRN-{EM,MC}-CLS, KRN-{EM,MC}-SVR (the
phi-space SVR statistic under the em_svr / mc_svr epilogues) and
KRN-{EM,MC}-MLT (the Crammer-Singer sweep on phi: one ``nystrom_phi`` a
step, then M ``fused_stats`` passes; ``nystrom_score`` with the M class
columns to predict), the drivers (``driver="stream"`` streams the raw
D-wide rows in chunks and featurizes each on the device, through
``nystrom_fused_stats``, or ``nystrom_phi`` for MLT and past m = 1,024),
and the mesh: with ``mesh`` every rank draws the same landmarks from the
same host rows and computes the same projection (replicated), and the
delegate fits in phi-space on the mesh, a ``k_shard_axis`` splitting the
phi columns of Sigma.

``fit_libsvm`` is the out-of-core nonlinear fit: one reservoir pass over
the file picks the landmarks (``data.reservoir_rows``), then the delegate
streams the raw rows through ``nystrom_fused_stats``. A warm start
(``fit(warm_start=...)``) reuses the installed featurizer, since the
donor's phi-space weights belong to it. ``export_servable`` / ``scorer``
serve the model through the Nystrom score cell (``serving``).

Not ported yet: ``resume_from`` (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.libsvm import iter_libsvm
from repro_torch.data.pipeline import reservoir_rows

from .kernel import gram_matrix
from .linear import PhiSpec
from .solver import FitResult, PEMSVM, SVMConfig, _device


def nystrom_projection(landmarks: np.ndarray, *, kind: str = "rbf",
                       sigma: float = 1.0, spectral_floor: float = 1e-6,
                       backend: str | None = None,
                       device=None) -> np.ndarray:
    """K_mm^{-1/2}, (m, m) float64: the landmark Gram on the device
    (``gram_matrix``), then one float64 eigendecomposition on the host.
    Eigenvalues at or below ``spectral_floor * max`` are dropped, which
    keeps the inverse square root bounded."""
    dev = _device(device)
    L = torch.from_numpy(np.asarray(landmarks, np.float32)).to(dev)
    K_mm = gram_matrix(L, L, kind=kind, sigma=sigma,
                       backend=backend).cpu().numpy().astype(np.float64)
    w, V = np.linalg.eigh(0.5 * (K_mm + K_mm.T))
    floor = spectral_floor * max(w.max(), 1e-30)
    keep = w > floor
    return (V[:, keep] / np.sqrt(w[keep])) @ V[:, keep].T


def nystrom_features(X: np.ndarray, landmarks: np.ndarray, *,
                     kind: str = "rbf", sigma: float = 1.0,
                     spectral_floor: float = 1e-6,
                     backend: str | None = None,
                     device=None) -> np.ndarray:
    """phi = K_nm @ K_mm^{-1/2}, (N, m) float32, projected in float64 on
    the host: the accuracy oracle; the fit featurizes on the device."""
    proj = nystrom_projection(landmarks, kind=kind, sigma=sigma,
                              spectral_floor=spectral_floor,
                              backend=backend, device=device)
    return _host_phi(X, landmarks, proj, kind, sigma, backend,
                     _device(device))


def _host_phi(X, landmarks, proj, kind, sigma, backend, device):
    """k(X, landmarks) on the device, projected in float64 on the host."""
    K_nm = gram_matrix(
        torch.from_numpy(np.asarray(X, np.float32)).to(device),
        torch.from_numpy(np.asarray(landmarks, np.float32)).to(device),
        kind=kind, sigma=sigma, backend=backend).cpu().numpy()
    return (K_nm.astype(np.float64)
            @ np.asarray(proj, np.float64)).astype(np.float32)


class NystromSVM:
    """KRN-{EM,MC}-{CLS,MLT,SVR} through Nystrom features and the linear
    solver, on ``cuda:0`` unless ``device`` says otherwise."""

    def __init__(self, config: SVMConfig, n_landmarks: int | None = None,
                 mesh=None, data_axes=None, seed: int = 0,
                 spectral_floor: float = 1e-6, device=None):
        if config.formulation != "KRN":
            raise ValueError("NystromSVM approximates KRN; got formulation "
                             f"{config.formulation!r}")
        self.config = config
        self.kernel_kind = config.kernel
        self.sigma = config.sigma
        self.n_landmarks = n_landmarks
        self.seed = seed
        self.spectral_floor = spectral_floor
        # The LIN delegate in phi-space: every field carries over; the
        # bias moves to phi-space (an X-space bias column would perturb
        # the RBF distances).
        lin_cfg = dataclasses.replace(
            config, formulation="LIN", add_bias=False,
            phi_spec=PhiSpec(sigma=config.sigma, kind=config.kernel,
                             add_bias=True))
        self.svm = PEMSVM(lin_cfg, device=device, mesh=mesh,
                          data_axes=data_axes)
        self._landmarks: np.ndarray | None = None
        self._proj: np.ndarray | None = None

    # ------------------------------------------------------------ fitting
    def _install_featurizer(self, landmarks: np.ndarray,
                            proj: np.ndarray | None = None) -> None:
        """Cache the landmark strip and K_mm^{-1/2} (computed here, once,
        unless given) and hand both to the delegate."""
        self._landmarks = np.asarray(landmarks, np.float32)
        if proj is None:
            proj = nystrom_projection(
                self._landmarks, kind=self.kernel_kind, sigma=self.sigma,
                spectral_floor=self.spectral_floor,
                backend=self.svm.config.backend, device=self.svm.device)
        self._proj = np.asarray(proj, np.float32)
        self.svm._phi_arrays = (self._landmarks, self._proj)

    def _continuing(self, fit_kw: dict) -> bool:
        """A warm-started fit reuses the installed featurizer: new
        landmarks would change the feature map under the donor's
        phi-space weights."""
        return (fit_kw.get("warm_start") is not None
                and self._landmarks is not None)

    def fit(self, X: np.ndarray, y: np.ndarray, **fit_kw) -> FitResult:
        """Fit on host arrays; m landmarks drawn without replacement by
        ``np.random.default_rng(seed)``, as the reference draws them,
        unless the fit continues (``warm_start``) on the installed
        featurizer. ``fit_kw`` goes to ``PEMSVM.fit``."""
        self._check_fit_kw(fit_kw)
        X = np.asarray(X, np.float32)
        if not self._continuing(fit_kw):
            N = X.shape[0]
            m = self.n_landmarks or int(np.ceil(np.sqrt(N)))
            rng = np.random.default_rng(self.seed)
            self._install_featurizer(
                X[rng.choice(N, size=min(m, N), replace=False)])
        return self.svm.fit(X, y, **fit_kw)

    def fit_featurized(self, X: np.ndarray, y: np.ndarray,
                       landmarks: np.ndarray, proj: np.ndarray,
                       **fit_kw) -> FitResult:
        """Fit with a given featurizer (landmarks and K_mm^{-1/2}, e.g.
        another model's), so two fits can share one feature map."""
        self._check_fit_kw(fit_kw)
        self._install_featurizer(landmarks, proj)
        return self.svm.fit(np.asarray(X, np.float32), y, **fit_kw)

    @staticmethod
    def _check_fit_kw(fit_kw: dict) -> None:
        if fit_kw.get("resume_from") is not None:
            raise NotImplementedError(
                "fit(resume_from=...) is not ported yet: ROADMAP queue 1 "
                "item 11 (reliability)")

    def fit_libsvm(self, path: str, n_features: int,
                   **fit_kw) -> FitResult:
        """Out-of-core nonlinear fit from a libsvm file: one reservoir
        pass picks the landmarks (O(m D) host memory; without
        ``n_landmarks`` a counting pass first, then m = ceil(sqrt(N))),
        then the delegate streams raw rows chunk by chunk and featurizes
        them on the device (with ``driver="stream"``; other drivers load
        the file). A continuing fit (``warm_start``) reuses the installed
        featurizer and skips the sampling pass."""
        self._check_fit_kw(fit_kw)
        cfg = self.svm.config
        if not self._continuing(fit_kw):
            chunks = iter_libsvm(path, cfg.chunk_rows, n_features)
            if self.n_landmarks:
                landmarks, _ = reservoir_rows(chunks, self.n_landmarks,
                                              seed=self.seed)
            else:
                n_valid = sum(int(np.sum(np.asarray(mc) > 0))
                              for _, _, mc in chunks)
                m = int(np.ceil(np.sqrt(n_valid)))
                landmarks, _ = reservoir_rows(
                    iter_libsvm(path, cfg.chunk_rows, n_features), m,
                    seed=self.seed)
            self._install_featurizer(landmarks)
        return self.svm.fit_libsvm(path, n_features, **fit_kw)

    # ---------------------------------------------------------- inference
    def _phi(self, X: np.ndarray, add_bias: bool = False) -> np.ndarray:
        """(N, m [+1]) features from the cached projection, projected in
        float64 on the host; the bias column, when asked for, goes LAST,
        as on the device path."""
        if self._proj is None:
            raise RuntimeError("fit first")
        phi = _host_phi(X, self._landmarks, self._proj, self.kernel_kind,
                        self.sigma, self.svm.config.backend, self.svm.device)
        if add_bias:
            phi = np.concatenate(
                [phi, np.ones((phi.shape[0], 1), np.float32)], axis=1)
        return phi

    def export_servable(self, *, name: str = "svm",
                        posterior_from: tuple | None = None):
        """Freeze into a ``serving.ServableModel`` (the Nystrom score
        cell; ``posterior_from=(X, y)`` adds the phi-space posterior
        uncertainty columns, exact here since the phi-space prior is
        lam^{-1} I). See ``PEMSVM.export_servable``."""
        return self.svm.export_servable(name=name,
                                        posterior_from=posterior_from)

    def scorer(self):
        """The cached device-resident ``serving.SVMScorer`` (see
        ``PEMSVM.scorer``)."""
        return self.svm.scorer()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.svm.predict(np.asarray(X, np.float32))

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return self.svm.decision_function(np.asarray(X, np.float32))

    def rmse(self, X: np.ndarray, y: np.ndarray) -> float:
        return self.svm.rmse(np.asarray(X, np.float32), y)

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        """Accuracy (CLS, MLT) or the negated RMSE (SVR): higher is
        better."""
        return self.svm.score(np.asarray(X, np.float32), y)
