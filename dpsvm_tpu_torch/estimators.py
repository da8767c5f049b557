"""scikit-learn-compatible estimator facade (counterpart of
dpsvm_tpu/estimators.py): ``SVC``, ``NuSVC``, ``SVR``, ``NuSVR`` and
``OneClassSVM`` with sklearn's fit / predict / score semantics, and
``svc_c_sweep``, on the port's solvers.

With scikit-learn installed the estimators subclass its BaseEstimator,
so get_params / set_params / clone, GridSearchCV and Pipeline work
unchanged; without it they fall back to plain base classes with the same
get_params / set_params. Every estimator takes ``device`` (None: the
CUDA card; "cpu" for the plain PyTorch path), a parameter the JAX
package's estimators do not have.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - exercised implicitly by import
    from sklearn.base import BaseEstimator, ClassifierMixin, OutlierMixin, RegressorMixin
except ImportError:  # sklearn genuinely absent: degrade to plain objects
    class BaseEstimator:  # type: ignore[no-redef]
        def get_params(self, deep=True):
            import inspect
            keys = inspect.signature(type(self).__init__).parameters
            return {k: getattr(self, k) for k in keys if k != "self"}

        def set_params(self, **params):
            for k, v in params.items():
                setattr(self, k, v)
            return self

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class RegressorMixin:  # type: ignore[no-redef]
        pass

    class OutlierMixin:  # type: ignore[no-redef]
        pass

from dpsvm_tpu_torch.config import SVMConfig

try:
    from sklearn.utils.metaestimators import available_if as _available_if
except ImportError:
    def _available_if(check):
        def deco(fn):
            return fn
        return deco


def _has_probability(est) -> bool:
    """predict_proba exists only when probability=True — sklearn.SVC's
    own contract (hasattr-based checks must see it absent, or every
    method-invariance/pickle check calls it and trips the
    AttributeError)."""
    if not est.probability:
        raise AttributeError(
            "predict_proba requires probability=True at fit time")
    return True


def _validate_fit(est, X, y=None, *, y_numeric=False, requires_y=True):
    """sklearn's fit-time input contract (estimator_checks battery):
    2-D finite real X (sparse rejected with the standard TypeError),
    ``n_features_in_``/``feature_names_in_`` recorded, y 1-D and
    length-matched (column-vector y warns + ravels), informative error
    on y=None for supervised estimators. Degrades to plain asarray when
    sklearn is absent."""
    try:
        from sklearn.utils.validation import validate_data
    except ImportError:
        X = np.asarray(X, np.float32)
        return (X, None) if y is None else (X, np.asarray(y))
    if y is None and not requires_y:
        return validate_data(est, X, dtype=np.float32), None
    # y=None on a supervised estimator raises the standard
    # "requires y to be passed" ValueError inside validate_data.
    return validate_data(est, X, y, dtype=np.float32, y_numeric=y_numeric)


def _validate_predict(est, X):
    """Predict-time counterpart: NotFittedError before fit, the same X
    contract, and a feature-count match against fit."""
    try:
        from sklearn.utils.validation import check_is_fitted, validate_data
    except ImportError:
        return np.asarray(X, np.float32)
    check_is_fitted(est)
    return validate_data(est, X, dtype=np.float32, reset=False)


def _check_classification_y(y):
    try:
        from sklearn.utils.multiclass import check_classification_targets
    except ImportError:
        return
    check_classification_targets(y)


def _resolve_gamma(gamma, x: np.ndarray) -> float:
    if gamma == "scale":
        var = float(x.var())
        return 1.0 / (x.shape[1] * var) if var > 0 else 1.0 / x.shape[1]
    if gamma == "auto":
        return 1.0 / x.shape[1]
    return float(gamma)


def _base_config(est, gamma: float) -> SVMConfig:
    return SVMConfig(
        c=est.C if hasattr(est, "C") else 1.0,
        gamma=gamma,
        kernel=est.kernel,
        degree=est.degree,
        coef0=est.coef0,
        epsilon=est.tol,
        max_iter=est.max_iter if est.max_iter > 0 else 150_000,
        selection=getattr(est, "selection", "mvp"),
        engine=getattr(est, "engine", "xla"),
        working_set_size=getattr(est, "working_set_size", 128),
        pair_batch=getattr(est, "pair_batch", 1),
        # None = auto (on when the per-pair engine's (n, n) Gram fits
        # the card's memory).
        gram_resident=getattr(est, "gram_resident", None),
        # Multiclass reductions and svc_c_sweep train up to fleet_size
        # submodels per fleet (solver/fleet.py).
        fleet_size=getattr(est, "fleet_size", 16),
        cache_lines=est.cache_lines,
        dtype=est.dtype,
    )


def _install_binary_fit(est, res, y_pm) -> None:
    """Shared binary fit-assembly: install (fit_result_, n_support_,
    n_iter_) from a SolveResult. One definition so SVC.fit (dense and
    precomputed branches) and svc_c_sweep can never drift on what a
    fitted binary estimator's counters mean."""
    est.fit_result_ = res
    sv_mask = np.asarray(res.alpha) > 0
    est.n_support_ = np.array(
        [(sv_mask & (y_pm < 0)).sum(), (sv_mask & (y_pm > 0)).sum()])
    est.n_iter_ = res.iterations


def _weighted_accuracy(pred, y, sample_weight=None) -> float:
    y = np.asarray(y)
    if sample_weight is not None:
        w = np.asarray(sample_weight, np.float64)
        return float(((pred == y) * w).sum() / w.sum())
    return float((pred == y).mean())


def _weighted_r2(pred, y, sample_weight=None) -> float:
    """R^2 as sklearn defines it (shared by the regressor facades)."""
    y = np.asarray(y, np.float64)
    pred = np.asarray(pred, np.float64)
    w = (np.ones_like(y) if sample_weight is None
         else np.asarray(sample_weight, np.float64))
    ss_res = float((w * (y - pred) ** 2).sum())
    ss_tot = float((w * (y - np.average(y, weights=w)) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


class SVC(ClassifierMixin, BaseEstimator):
    """C-SVC with sklearn semantics on the port's solvers.

    Binary or multiclass labels of any type; multiclass reduces by
    one-vs-rest or one-vs-one (``strategy``), through the fleet where
    the config allows (models/multiclass.py). ``class_weight`` ({label:
    w} or "balanced") applies to binary problems, as LibSVM's -w.
    kernel="precomputed" takes the (n, n) Gram as X and K(test, train)
    at prediction. Prediction evaluates in float32, as sklearn's; for an
    extreme-C binary model, predict.decision_function(model, X,
    precision="float64") evaluates exactly on the host."""

    def __init__(self, C=1.0, kernel="rbf", degree=3, gamma="scale",
                 coef0=0.0, tol=1e-3, max_iter=-1, class_weight=None,
                 strategy="ovr", backend="auto", selection="mvp",
                 engine="xla", working_set_size=128, pair_batch=1,
                 gram_resident=None, fleet_size=16, cache_lines=0,
                 dtype="float32", probability=False, probability_cv=3,
                 random_state=0, device=None):
        self.gram_resident = gram_resident
        self.fleet_size = fleet_size
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.class_weight = class_weight
        self.strategy = strategy
        self.backend = backend
        self.selection = selection
        self.engine = engine
        self.working_set_size = working_set_size
        self.pair_batch = pair_batch
        self.cache_lines = cache_lines
        self.dtype = dtype
        self.probability = probability
        self.probability_cv = probability_cv
        self.random_state = random_state
        self.device = device

    def _weights(self, y: np.ndarray, classes: np.ndarray) -> tuple:
        """(weight_pos, weight_neg) of a binary problem where classes[1]
        maps to +1 and classes[0] to -1."""
        if self.class_weight is None:
            return 1.0, 1.0
        if self.class_weight == "balanced":
            n = y.shape[0]
            counts = {c: int((y == c).sum()) for c in classes}
            return (n / (2.0 * counts[classes[1]]),
                    n / (2.0 * counts[classes[0]]))
        return (float(self.class_weight.get(classes[1], 1.0)),
                float(self.class_weight.get(classes[0], 1.0)))

    def fit(self, X, y):
        from dpsvm_tpu_torch.models.multiclass import train_multiclass
        from dpsvm_tpu_torch.train import train

        X, y = _validate_fit(self, X, y)
        _check_classification_y(y)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if self.classes_.shape[0] < 2:
            raise ValueError(
                f"SVC needs at least 2 classes; the data has "
                f"{self.classes_.shape[0]} class")
        if (self.probability and self.classes_.shape[0] > 2
                and self.strategy != "ovr"):
            raise ValueError(
                "probability=True requires strategy='ovr' for multiclass "
                "(per-class Platt + normalization)")
        if self.kernel == "precomputed":
            return self._fit_precomputed(X, y)
        self._pre_coef = None
        cfg = _base_config(self, _resolve_gamma(self.gamma, X))
        if self.classes_.shape[0] == 2:
            wp, wn = self._weights(y, self.classes_)
            cfg = cfg.replace(weight_pos=wp, weight_neg=wn)
            y_pm = np.where(y == self.classes_[1], 1, -1).astype(np.int32)
            model, res = train(X, y_pm, cfg, backend=self.backend,
                               device=self.device)
            self._binary_model = model
            self._multiclass_model = None
            _install_binary_fit(self, res, y_pm)
            if self.probability:
                self._platt = self._fit_platt_cv(X, y_pm, cfg)
        else:
            if self.class_weight is not None:
                raise ValueError(
                    "class_weight is only supported for binary problems "
                    "(per-class weights do not decompose over OvR/OvO "
                    "splits)")
            mc, results = train_multiclass(
                X, y, cfg, strategy=self.strategy, backend=self.backend,
                device=self.device)
            self._binary_model = None
            self._multiclass_model = mc
            self.fit_result_ = results
            self.n_iter_ = int(sum(r.iterations for r in results))
            if self.probability:
                self._platt = [
                    self._fit_platt_cv(
                        X, np.where(y == cl, 1, -1).astype(np.int32), cfg)
                    for cl in self.classes_]
        return self

    def _fit_precomputed(self, X, y):
        """LibSVM -t 4: X is the (n, n) Gram. The fit keeps (support
        indices, dual coef, b), and prediction takes K(test, train)."""
        from dpsvm_tpu_torch.solver.solve import solve

        # gamma means nothing here ('scale' would run an O(n^2) variance
        # pass over the Gram): a dummy value.
        cfg = _base_config(self, 1.0)
        if self.backend not in ("auto", "single"):
            raise ValueError(
                "kernel='precomputed' is single-chip only this round; "
                "use backend='auto' or 'single'")
        if self.classes_.shape[0] != 2:
            raise ValueError(
                "kernel='precomputed' supports binary problems only "
                "(the OvR/OvO reductions would need per-split Gram "
                "sub-matrices)")
        if self.probability:
            raise ValueError(
                "probability=True is not supported with "
                "kernel='precomputed' (the CV folds would need "
                "per-fold Gram sub-matrices)")
        wp, wn = self._weights(y, self.classes_)
        cfg = cfg.replace(weight_pos=wp, weight_neg=wn)
        y_pm = np.where(y == self.classes_[1], 1, -1).astype(np.int32)
        res = solve(np.asarray(X, np.float32), y_pm, cfg,
                    device=self.device)
        self._binary_model = None
        self._multiclass_model = None
        self._pre_n = int(X.shape[0])
        alpha = np.asarray(res.alpha)
        self.support_ = np.nonzero(alpha > 0)[0].astype(np.int32)
        self._pre_coef = (alpha * y_pm)[self.support_].astype(np.float64)
        self._pre_b = float(res.b)
        _install_binary_fit(self, res, y_pm)
        return self

    def _fit_platt_cv(self, X, y_pm, cfg):
        from dpsvm_tpu_torch.models.platt import fit_platt_cv

        # random_state passes through: None keeps sklearn's fresh entropy
        # per fit, 0 is a seed of its own.
        return fit_platt_cv(X, y_pm, cfg, backend=self.backend,
                            k=self.probability_cv, seed=self.random_state,
                            device=self.device)

    @_available_if(_has_probability)
    def predict_proba(self, X):
        """Class probabilities (n, k), classes in ``classes_`` order;
        only with probability=True (sklearn.SVC's contract)."""
        from dpsvm_tpu_torch.models.platt import (platt_probability,
                                                  platt_probability_matrix)

        X = _validate_predict(self, X)
        if self._binary_model is not None:
            p_pos = platt_probability(self.decision_function(X),
                                      *self._platt)
            return np.stack([1.0 - p_pos, p_pos], axis=1)
        from dpsvm_tpu_torch.models.multiclass import decision_matrix

        scores = decision_matrix(self._multiclass_model, X,
                                 device=self.device)
        probs = platt_probability_matrix(scores, self._platt)
        probs = np.clip(probs, 1e-12, 1.0)
        return probs / probs.sum(axis=1, keepdims=True)

    def decision_function(self, X):
        """(n,) for binary, (n, k) per-class scores otherwise (OvO folds
        to per-class vote scores, sklearn's default ovr shape)."""
        from dpsvm_tpu_torch.predict import decision_function

        X = _validate_predict(self, X)
        if getattr(self, "_pre_coef", None) is not None:
            # X is K(test, train): columns indexed by the support set.
            if X.ndim != 2 or X.shape[1] != self._pre_n:
                raise ValueError(
                    f"kernel='precomputed' prediction needs K(test, train) "
                    f"with {self._pre_n} columns (one per training row); "
                    f"got shape {X.shape}")
            return X[:, self.support_] @ self._pre_coef - self._pre_b
        if self._binary_model is not None:
            return decision_function(self._binary_model, X,
                                     device=self.device)
        from dpsvm_tpu_torch.models.multiclass import vote_matrix

        return vote_matrix(self._multiclass_model, X, device=self.device)

    def predict(self, X):
        X = _validate_predict(self, X)
        if (getattr(self, "_pre_coef", None) is not None
                or self._binary_model is not None):
            d = self.decision_function(X)
            return np.where(d >= 0, self.classes_[1], self.classes_[0])
        from dpsvm_tpu_torch.models.multiclass import predict_multiclass

        return predict_multiclass(self._multiclass_model, X,
                                  device=self.device)

    def score(self, X, y, sample_weight=None):
        return _weighted_accuracy(self.predict(X), y, sample_weight)


def svc_c_sweep(X, y, Cs, warm=False, **svc_params) -> list:
    """Fit one binary ``SVC`` per value of `Cs`, all of them batched
    through the fleet (solver/fleet.py): the box bound is a per-problem
    value, the shared X (or resident Gram) is uploaded once, and the
    sweep runs ceil(len(Cs) / fleet_size) fleets instead of len(Cs)
    solves. Returns fitted SVC estimators in `Cs` order, each with its
    own ``fit_result_``. `svc_params` go to every SVC (``device``
    included); binary labels only, and probability, class_weight and
    precomputed kernels are refused. One device by construction:
    backend must be 'single', or 'auto' on a one-card host.

    ``warm=True`` is the regularization-path walk: the Cs are visited in
    ascending order on one device, each solve seeded from the previous
    C's alphas (solver/warmstart.py repairs the seed into the new box
    and rebuilds its gradient in one streamed pass), in place of the
    fleet; any engine runs it. Results still come back in `Cs` order."""
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.ops.kernels import KernelParams
    from dpsvm_tpu_torch.solver.fleet import (FleetProblem, fleet_chunks,
                                              fleet_routing_reasons,
                                              solve_fleet)

    Cs = [float(c) for c in Cs]
    if not Cs:
        raise ValueError("Cs must be non-empty")
    template = SVC(C=Cs[0], **svc_params)
    if template.probability:
        raise ValueError("svc_c_sweep does not support probability=True "
                         "(per-C Platt CV refits are sequential work)")
    if template.class_weight is not None:
        raise ValueError("svc_c_sweep does not support class_weight")
    if template.backend != "single":
        import torch

        multi = (template.backend == "auto" and template.device is None
                 and torch.cuda.device_count() > 1)
        if template.backend != "auto" or multi:
            raise ValueError(
                f"svc_c_sweep is single-chip (the fleet executor); "
                f"backend={template.backend!r} on this host would "
                "de-shard the solves — pass backend='single' to accept "
                "the single-chip sweep, or fit per-C with SVC")
    reasons = [] if warm else fleet_routing_reasons(
        _base_config(template, 1.0))
    if reasons:
        raise ValueError(
            "svc_c_sweep cannot route this config through the fleet "
            "executor: " + "; ".join(reasons)
            + " — fit such configs per-C with SVC instead")
    X, y = _validate_fit(template, X, y)
    _check_classification_y(y)
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    if classes.shape[0] != 2:
        raise ValueError(
            f"svc_c_sweep is binary-only ({classes.shape[0]} classes "
            "found); sweep a multiclass SVC per-C instead")
    y_pm = np.where(y == classes[1], 1, -1).astype(np.int32)
    cfg = _base_config(template, _resolve_gamma(template.gamma, X))
    kp = KernelParams(cfg.kernel, cfg.resolve_gamma(X.shape[1]),
                      cfg.degree, cfg.coef0)
    if warm:
        # Ascending C: the previous optimum sits inside the next (larger)
        # box, so the repair only absorbs rounding.
        from dpsvm_tpu_torch.solver.solve import solve
        from dpsvm_tpu_torch.solver.warmstart import WarmStart

        results = [None] * len(Cs)
        prev_alpha = None
        for pos in np.argsort(Cs, kind="stable"):
            ws = (WarmStart(alpha=prev_alpha)
                  if prev_alpha is not None and prev_alpha.any() else None)
            res = solve(X, y_pm, cfg.replace(c=Cs[pos]),
                        device=template.device, warm_start=ws)
            prev_alpha = np.asarray(res.alpha, np.float64)
            results[pos] = res
    else:
        problems = [FleetProblem(y=y_pm, c=c, tag=("C", c)) for c in Cs]
        results = []
        for chunk in fleet_chunks(problems, cfg.fleet_size):
            results.extend(solve_fleet(X, chunk, cfg,
                                       device=template.device))
    fitted = []
    for c, res in zip(Cs, results):
        est = SVC(C=c, **svc_params)
        est.classes_ = classes
        # The fit metadata validate_data recorded on the template.
        est.n_features_in_ = getattr(template, "n_features_in_",
                                     X.shape[1])
        if hasattr(template, "feature_names_in_"):
            est.feature_names_in_ = template.feature_names_in_
        est._binary_model = SVMModel.from_dense(X, y_pm, res.alpha, res.b,
                                                kp)
        est._multiclass_model = None
        est._pre_coef = None
        _install_binary_fit(est, res, y_pm)
        fitted.append(est)
    return fitted


class SVR(RegressorMixin, BaseEstimator):
    """epsilon-SVR with sklearn semantics on the port's solvers."""

    def __init__(self, C=1.0, kernel="rbf", degree=3, gamma="scale",
                 coef0=0.0, tol=1e-3, epsilon=0.1, max_iter=-1,
                 backend="auto", selection="mvp", engine="xla",
                 working_set_size=128, pair_batch=1, gram_resident=None,
                 cache_lines=0, dtype="float32", device=None):
        self.gram_resident = gram_resident
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.epsilon = epsilon
        self.max_iter = max_iter
        self.backend = backend
        self.selection = selection
        self.engine = engine
        self.working_set_size = working_set_size
        self.pair_batch = pair_batch
        self.cache_lines = cache_lines
        self.dtype = dtype
        self.device = device

    def fit(self, X, y):
        from dpsvm_tpu_torch.models.svr import train_svr

        X, y = _validate_fit(self, X, y, y_numeric=True)
        y = np.asarray(y, np.float32)
        cfg = _base_config(self, _resolve_gamma(self.gamma, X))
        backend = "single" if self.backend == "auto" else self.backend
        self._model, res = train_svr(X, y, cfg, svr_epsilon=self.epsilon,
                                     backend=backend, device=self.device)
        self.fit_result_ = res
        self.n_iter_ = res.iterations
        return self

    def predict(self, X):
        X = _validate_predict(self, X)
        return self._model.predict(X, device=self.device)

    def score(self, X, y, sample_weight=None):
        return _weighted_r2(self.predict(X), y, sample_weight)


class OneClassSVM(OutlierMixin, BaseEstimator):
    """nu-one-class SVM with sklearn semantics on the port's solvers."""

    def __init__(self, nu=0.5, kernel="rbf", degree=3, gamma="scale",
                 coef0=0.0, tol=1e-3, max_iter=-1, backend="auto",
                 engine="xla", working_set_size=128,
                 cache_lines=0, dtype="float32", device=None):
        self.nu = nu
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.backend = backend
        self.engine = engine
        self.working_set_size = working_set_size
        self.cache_lines = cache_lines
        self.dtype = dtype
        self.device = device

    def fit(self, X, y=None):
        from dpsvm_tpu_torch.models.oneclass import train_oneclass

        X, _ = _validate_fit(self, X, requires_y=False)
        cfg = _base_config(self, _resolve_gamma(self.gamma, X))
        backend = "single" if self.backend == "auto" else self.backend
        self._model, res = train_oneclass(X, nu=self.nu, config=cfg,
                                          backend=backend,
                                          device=self.device)
        self.fit_result_ = res
        self.n_iter_ = res.iterations
        # sklearn's convention: decision_function = score_samples -
        # offset_, with offset_ = rho.
        self.offset_ = float(self._model.rho)
        return self

    def decision_function(self, X):
        X = _validate_predict(self, X)
        # float64 out, sklearn's outlier API contract.
        return self._model.decision_function(
            X, device=self.device).astype(np.float64)

    def score_samples(self, X):
        """The unshifted kernel sum: decision_function + offset_."""
        return self.decision_function(X) + self.offset_

    def predict(self, X):
        return np.where(self.decision_function(X) >= 0, 1, -1)


class NuSVC(ClassifierMixin, BaseEstimator):
    """nu-SVC with sklearn semantics on the port's nu duals
    (models/nusvm.py). Multiclass reduces by one-vs-one with the nu
    trainer under each pair, as sklearn.svm.NuSVC does (nu bounds the
    margin-error and SV fractions per pair)."""

    def __init__(self, nu=0.5, kernel="rbf", degree=3, gamma="scale",
                 coef0=0.0, tol=1e-3, max_iter=-1, backend="auto",
                 cache_lines=0, dtype="float32", device=None):
        self.nu = nu
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.backend = backend
        self.cache_lines = cache_lines
        self.dtype = dtype
        self.device = device

    def fit(self, X, y):
        from dpsvm_tpu_torch.models.nusvm import train_nusvc

        X, y = _validate_fit(self, X, y)
        _check_classification_y(y)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if self.classes_.shape[0] < 2:
            raise ValueError(
                f"NuSVC needs at least 2 classes; the data has "
                f"{self.classes_.shape[0]} class")
        cfg = _base_config(self, _resolve_gamma(self.gamma, X))
        if self.classes_.shape[0] == 2:
            y_pm = np.where(y == self.classes_[1], 1, -1).astype(np.int32)
            self._model, res = train_nusvc(X, y_pm, nu=self.nu, config=cfg,
                                           backend=self.backend,
                                           device=self.device)
            self._multiclass_model = None
            self.fit_result_ = res
            self.n_iter_ = res.iterations
            return self
        # Multiclass: OvO with the nu-SVC trainer under it (pad_to is
        # ignored: the nu start point depends on exact class counts).
        from dpsvm_tpu_torch.models.multiclass import train_multiclass

        def nu_trainer(xx, yy, c, backend="auto", num_devices=None,
                       pad_to=None):
            return train_nusvc(xx, yy, nu=self.nu, config=c,
                               backend=backend, num_devices=num_devices,
                               device=self.device)

        mc, results = train_multiclass(X, y, cfg, strategy="ovo",
                                       backend=self.backend,
                                       trainer=nu_trainer,
                                       device=self.device)
        self._model = None
        self._multiclass_model = mc
        self.fit_result_ = results
        self.n_iter_ = int(sum(r.iterations for r in results))
        return self

    def decision_function(self, X):
        from dpsvm_tpu_torch.predict import decision_function

        X = _validate_predict(self, X)
        if self._model is None:
            from dpsvm_tpu_torch.models.multiclass import vote_matrix

            return vote_matrix(self._multiclass_model, X,
                               device=self.device)
        return decision_function(self._model, X, device=self.device)

    def predict(self, X):
        scores = self.decision_function(X)
        if scores.ndim == 2:  # multiclass: per-class vote scores
            return self.classes_[np.argmax(scores, axis=1)]
        return self.classes_[(scores > 0).astype(int)]

    def score(self, X, y, sample_weight=None):
        return _weighted_accuracy(self.predict(X), y, sample_weight)


class NuSVR(RegressorMixin, BaseEstimator):
    """nu-SVR with sklearn semantics on the port's nu duals: nu replaces
    the epsilon tube width (models/nusvm.py)."""

    def __init__(self, nu=0.5, C=1.0, kernel="rbf", degree=3, gamma="scale",
                 coef0=0.0, tol=1e-3, max_iter=-1, backend="auto",
                 cache_lines=0, dtype="float32", device=None):
        self.nu = nu
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.backend = backend
        self.cache_lines = cache_lines
        self.dtype = dtype
        self.device = device

    def fit(self, X, y):
        from dpsvm_tpu_torch.models.nusvm import train_nusvr

        X, y = _validate_fit(self, X, y, y_numeric=True)
        y = np.asarray(y, np.float32)
        cfg = _base_config(self, _resolve_gamma(self.gamma, X))
        self._model, res = train_nusvr(X, y, nu=self.nu, c=self.C,
                                       config=cfg, backend=self.backend,
                                       device=self.device)
        self.fit_result_ = res
        self.n_iter_ = res.iterations
        return self

    def predict(self, X):
        X = _validate_predict(self, X)
        return self._model.predict(X, device=self.device)

    def score(self, X, y, sample_weight=None):
        return _weighted_r2(self.predict(X), y, sample_weight)
