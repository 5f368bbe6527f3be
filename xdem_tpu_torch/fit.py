"""Robust functional fitting: model functions, losses and optimizers.

Port of xdem_tpu/fit.py. The models evaluate on numpy arrays or torch tensors. The
Levenberg-Marquardt solver runs in float32 on the device of its data (numpy data, such as a
table of bin medians, stay on the host CPU), a Python loop whose stop test reads the step's
acceptance once per iteration, with ``torch.func.jacfwd`` for the Jacobian and ``J.T @ J`` at
full float32 (TF32 stays off). The polynomial fits are robust
IRLS in float64 on the host; the sum of sines is a periodogram over a wavelength grid, then a
joint LM polish.

``linear_pkg="sklearn"`` needs scikit-learn, which this package does not depend on: it is
imported only when asked for, and its absence raises an ImportError that names it.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Literal, Sequence

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.ops.transfer import unmask

# --------------------------------------------------------------------------- losses


def _residuals(ytrue: np.ndarray, ypred: np.ndarray | None) -> np.ndarray:
    """One-argument calls pass residuals; two-argument calls are (ytrue, ypred)."""
    z = np.asarray(ytrue)
    return z if ypred is None else z - np.asarray(ypred)


def rmse(ytrue: np.ndarray, ypred: np.ndarray | None = None) -> float:
    """Root mean square of residuals: ``rmse(residuals)`` or ``rmse(ytrue, ypred)``.

    >>> rmse(np.array([3.0, -4.0]))
    3.5355339059327378
    """
    return float(np.sqrt(np.nanmean(np.square(_residuals(ytrue, ypred)))))


def huber_loss(ytrue: np.ndarray, ypred: np.ndarray | None = None) -> float:
    """Huber loss: L2 near zero, L1 in the tails (delta = 1)."""
    z = _residuals(ytrue, ypred)
    return float(np.where(np.abs(z) < 1, 0.5 * np.square(z), np.abs(z) - 0.5).sum())


def soft_loss(ytrue: np.ndarray, ypred: np.ndarray | None = None, scale: float = 0.5) -> float:
    """Smooth approximation of the L1 loss (scipy least_squares' 'soft_l1')."""
    if ypred is not None and np.ndim(ypred) == 0:
        raise TypeError("soft_loss's second argument is ypred; pass the scale as a keyword: soft_loss(z, scale=...).")
    z = _residuals(ytrue, ypred)
    return float(np.sum(np.square(scale) * 2 * (np.sqrt(1 + np.square(z / scale)) - 1)))


# --------------------------------------------------------------------------- models


def _param_vector(params: Sequence[Any], like: torch.Tensor) -> torch.Tensor:
    """The parameters as one tensor on the device of `like` (they may be tensors traced by
    ``torch.func``, or numbers)."""
    return torch.stack([torch.as_tensor(p, dtype=like.dtype, device=like.device) for p in params])


def sumsin_1d(xx: Any, *params: float) -> Any:
    """Sum of N sinusoids: 3N parameters (amplitude, wavelength, phase) per frequency."""
    if isinstance(xx, torch.Tensor):
        p = _param_vector(params, xx).reshape(len(params) // 3, 3)
        xf = xx.reshape(-1)
        out = torch.sum(p[:, 0][None, :] * torch.sin(2 * torch.pi / p[:, 1][None, :] * xf[:, None] + p[:, 2][None, :]),
                        dim=1)
        return out.reshape(xx.shape)
    p = np.asarray(params).reshape((len(params) // 3, 3))
    x = np.asarray(xx)
    xf = x.ravel()
    out = np.sum(p[:, 0][None, :] * np.sin(2 * np.pi / p[:, 1][None, :] * xf[:, None] + p[:, 2][None, :]), axis=1)
    return out.reshape(x.shape)


def polynomial_1d(xx: Any, *params: float) -> Any:
    """1-D polynomial sum(p[i] * x**i).

    >>> polynomial_1d(np.array([0.0, 1.0, 2.0]), 1.0, 0.0, 2.0)
    array([1., 3., 9.])
    """
    x = xx if isinstance(xx, torch.Tensor) else np.asarray(xx)
    return sum(p * x**i for i, p in enumerate(params))


def polynomial_2d(xx: tuple[Any, Any], *params: float) -> Any:
    """2-D polynomial of degree p with p^2 coefficients, evaluated as polyval2d."""
    x, y = xx
    p = int(np.sqrt(len(params)))
    if p**2 != len(params):
        raise ValueError("The number of parameters of the 2D polynomial must be a perfect square.")
    if isinstance(x, torch.Tensor):
        c = _param_vector(params, x).reshape(p, p)
    else:
        x, y = np.asarray(x), np.asarray(y)
        c = np.asarray(params).reshape((p, p))
    out = 0.0
    for i in range(p):
        for j in range(p):
            out = out + c[i, j] * x**i * y**j
    return out


# --------------------------------------------------------------------------- LM solver


def _lm_loop(residual_fn: Callable[[torch.Tensor], torch.Tensor], p0: torch.Tensor, max_iter: int, tol: float,
             lam0: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt in float32 on the device of `p0`: damped normal equations with a
    diagonal scaled by max(diag(J^T J), 1e-12), a step accepted only when it lowers the cost
    (the damping x0.3 on acceptance, x3 otherwise). Stops after `max_iter` steps, when an
    accepted step improves the cost by no more than `tol` of it, or when the damping reaches
    1e12. Returns (parameters, cost)."""
    jac = torch.func.jacfwd(residual_fn)

    def cost(p):
        r = residual_fn(p)
        return 0.5 * torch.sum(r * r)

    p = p0.to(torch.float32)
    lam = torch.tensor(lam0, dtype=p.dtype, device=p.device)
    c = cost(p)
    it, keep_going, lam_f = 0, True, float(lam)
    while it < max_iter and keep_going and lam_f < 1e12:
        r = residual_fn(p)
        J = jac(p)
        JTJ = J.T @ J
        A = JTJ + lam * torch.diag(torch.clamp(torch.diagonal(JTJ), min=1e-12))
        p_new = p - torch.linalg.solve(A, J.T @ r)
        c_new = cost(p_new)
        accept = c_new < c
        p = torch.where(accept, p_new, p)
        lam = torch.where(accept, lam * 0.3, lam * 3.0)
        improved = torch.abs(c - c_new) > tol * torch.clamp(c, min=1e-30)
        c = torch.where(accept, c_new, c)
        keep_going, lam_f = torch.stack([(improved | ~accept).to(p.dtype), lam]).tolist()
        it += 1
    return p, c


def levenberg_marquardt(residual_fn: Callable[[torch.Tensor], torch.Tensor], p0: Any, max_iter: int = 50,
                        tol: float = 1e-10, lam0: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt on a residual function of a parameter tensor; returns
    (parameters, final cost)."""
    return _lm_loop(residual_fn, as_tensor(p0), max_iter, tol, lam0)


def _lm_data(func: Callable[..., torch.Tensor], x: torch.Tensor, y0: torch.Tensor, w: Any, p0: torch.Tensor,
             n_params: int, max_iter: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """LM of ``(func(x, *p) - y0) * w``."""

    def residual(p):
        return (func(x, *[p[i] for i in range(n_params)]) - y0) * w

    return _lm_loop(residual, p0, max_iter, 1e-10, 1e-3)


def curve_fit_lm(func: Callable[..., Any], xdata: Any, ydata: Any, p0: Sequence[float], sigma: Any = None,
                 max_iter: int = 50) -> np.ndarray:
    """curve_fit-like wrapper of the LM solver, NaN-masked and optionally weighted by
    1/sigma. A tuple `xdata` (several variables) is stacked. Runs on the device of `ydata`
    (numpy on the host CPU); returns float64 numpy parameters."""
    y = as_tensor(ydata, device=None if isinstance(ydata, torch.Tensor) else "cpu")
    x = torch.stack([as_tensor(v, device=y.device) for v in xdata]) if isinstance(xdata, tuple) \
        else as_tensor(xdata, device=y.device)
    fin = torch.isfinite(y)
    w = fin.to(torch.float32)
    if sigma is not None:
        s = as_tensor(sigma, device=y.device)
        w = w / torch.where(s > 0, s, torch.inf)
    y0 = torch.where(fin, y, 0.0)
    p, _ = _lm_data(func, x, y0, w, torch.tensor(list(p0), dtype=torch.float32, device=y.device),
                    n_params=len(p0), max_iter=max_iter)
    return p.double().cpu().numpy()


# --------------------------------------------------------------------------- robust polynomials


def _irls_polyfit(x: np.ndarray, y: np.ndarray, degree: int, loss: Literal["linear", "huber", "soft_l1"] = "huber",
                  f_scale: float = 0.1, n_iter: int = 20, sigma: np.ndarray | None = None) -> np.ndarray:
    """Iteratively reweighted least squares for a robust polynomial fit (float64, host);
    `sigma` gives each point a 1/sigma base weight."""
    V = np.vander(x, degree + 1, increasing=True)
    base = np.ones_like(y) if sigma is None else 1.0 / np.where(sigma > 0, sigma, np.inf)
    w = base.copy()
    coefs = None
    for _ in range(n_iter if loss != "linear" else 1):
        coefs, *_ = np.linalg.lstsq(V * w[:, None], y * w, rcond=None)
        r = (V @ coefs - y) / f_scale
        if loss == "huber":
            w = base * np.where(np.abs(r) <= 1, 1.0, 1.0 / np.sqrt(np.abs(r)))
        elif loss == "soft_l1":
            w = base * (1 + r**2) ** -0.25
        else:
            break
    return coefs


def _choice_best_order(cost: np.ndarray, margin_improvement: float = 20.0) -> int:
    """Lowest order whose cost is within `margin_improvement` % of the minimum cost."""
    min_cost = cost[int(np.argmin(cost))]
    return int(min(i for i in range(len(cost)) if cost[i] < min_cost + margin_improvement / 100.0 * min_cost))


def robust_norder_polynomial_fit(
    xdata: np.ndarray,
    ydata: np.ndarray,
    sigma: np.ndarray | None = None,
    max_order: int = 6,
    estimator_name: Literal["Linear", "Theil-Sen", "RANSAC", "Huber"] = "Huber",
    cost_func: Callable[[np.ndarray], float] = soft_loss,
    margin_improvement: float = 20.0,
    subsample: float | int = 1,
    linear_pkg: Literal["scipy", "sklearn"] = "scipy",
    random_state: int | None = None,
    **kwargs: Any,
) -> tuple[np.ndarray, int]:
    """Fit polynomials of order 1..max_order robustly and keep the best order (the lowest
    within `margin_improvement` % of the least cost). Returns (coefficients padded to
    max_order + 1 and rounded to 5 decimals, degree)."""
    x = np.asarray(unmask(xdata), dtype=np.float64).ravel()
    y = np.asarray(unmask(ydata), dtype=np.float64).ravel()
    s = np.asarray(sigma, dtype=np.float64).ravel() if sigma is not None else None
    valid = np.isfinite(x) & np.isfinite(y)
    x, y = x[valid], y[valid]
    if s is not None:
        s = s[valid]
    if subsample != 1 and len(x) > 0:
        n = len(x)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        idx = np.random.default_rng(random_state).choice(n, min(count, n), replace=False)
        x, y = x[idx], y[idx]
        if s is not None:
            s = s[idx]

    costs = np.empty(max_order)
    coefs_list: list[np.ndarray] = []
    for deg in range(1, max_order + 1):
        if linear_pkg == "sklearn":
            c = _sklearn_polyfit(x, y, deg, estimator_name, random_state=random_state, sigma=s, **kwargs)
        else:
            c = _irls_polyfit(x, y, deg, loss="huber", sigma=s)
        costs[deg - 1] = cost_func(polynomial_1d(x, *c) - y)
        coefs_list.append(c)

    best = _choice_best_order(costs, margin_improvement=margin_improvement)
    out = np.zeros(max_order + 1)
    out[: best + 2] = np.round(coefs_list[best], 5)
    return out, best + 1


def _sklearn_polyfit(x: np.ndarray, y: np.ndarray, degree: int, estimator_name: str,
                     random_state: int | None = None, sigma: np.ndarray | None = None, **kwargs: Any) -> np.ndarray:
    """Robust linear estimators of scikit-learn over a polynomial feature expansion; `sigma`
    becomes sample_weight = 1/sigma^2 where the estimator takes it."""
    try:
        lm = importlib.import_module("sklearn.linear_model")
    except ImportError as err:
        raise ImportError("linear_pkg='sklearn' needs scikit-learn, which is not installed; "
                          "use linear_pkg='scipy'.") from err
    est_map = {
        "Linear": lm.LinearRegression(),
        "Theil-Sen": lm.TheilSenRegressor(random_state=random_state),
        "RANSAC": lm.RANSACRegressor(random_state=random_state),
        "Huber": lm.HuberRegressor(max_iter=1000),
    }
    if estimator_name not in est_map:
        raise ValueError(f"Attribute estimator must be one of {list(est_map)}, not {estimator_name}.")
    est = est_map[estimator_name]
    V = np.vander(x, degree + 1, increasing=True)[:, 1:]  # the estimator fits the intercept
    if sigma is not None and "sample_weight" in inspect.signature(est.fit).parameters:
        est.fit(V, y, sample_weight=1.0 / sigma**2)
    else:
        est.fit(V, y)
    inner = est.estimator_ if estimator_name == "RANSAC" else est
    return np.r_[inner.intercept_, inner.coef_]


# --------------------------------------------------------------------------- sum of sines


def _periodogram_best_wavelength(x: np.ndarray, y: np.ndarray, wavelengths: np.ndarray):
    """For each candidate wavelength L, the linear least squares
    y ~ A sin(2 pi x / L) + B cos(2 pi x / L) + C; returns per-candidate (rss, (A, B, C))."""
    w = 2 * np.pi / wavelengths[:, None]
    S = np.sin(w * x[None, :])
    C = np.cos(w * x[None, :])
    G = np.stack([S, C, np.broadcast_to(np.ones_like(x), S.shape)], axis=1)  # (L, 3, N)
    A = G @ G.transpose(0, 2, 1)
    b = G @ y
    sol = np.linalg.solve(A + 1e-9 * np.eye(3)[None], b[..., None])[..., 0]
    pred = np.einsum("lkn,lk->ln", G, sol)
    return np.sum((pred - y[None, :]) ** 2, axis=1), sol


def robust_nfreq_sumsin_fit(
    xdata: np.ndarray,
    ydata: np.ndarray,
    sigma: np.ndarray | None = None,
    max_nb_frequency: int = 3,
    bounds_amp_wave_phase: Sequence[tuple[float, float]] | None = None,
    cost_func: Callable[[np.ndarray], float] = soft_loss,
    subsample: float | int = 1,
    hop_length: float | None = None,
    random_state: int | None = None,
    **kwargs: Any,
) -> tuple[np.ndarray, int]:
    """Fit a sum of up to N sinusoids: greedy periodogram extraction, then a joint LM polish
    of all extracted frequencies. Returns (3N coefficients [amplitude, wavelength, phase]
    sorted by decreasing amplitude, N). `sigma` is accepted and unused, as in xdem_tpu."""
    x = np.asarray(unmask(xdata), dtype=np.float64).ravel()
    y = np.asarray(unmask(ydata), dtype=np.float64).ravel()
    valid = np.isfinite(x) & np.isfinite(y)
    x, y = x[valid], y[valid]
    rng = np.random.default_rng(random_state)
    if subsample != 1 and len(x) > 0:
        n = len(x)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        idx = rng.choice(n, min(count, n), replace=False)
        x, y = x[idx], y[idx]
    if len(x) < 10:
        raise ValueError("Too few valid points for sum-of-sinusoids fit.")

    span = np.max(x) - np.min(x)
    if hop_length is None:
        hop_length = span / max(len(x), 1)
    res_x = max(hop_length, span / max(len(x) - 1, 1))
    y_amp = (np.nanmax(y) - np.nanmin(y)) / 2 if len(y) else 1.0
    lam_min, lam_max = 3 * res_x, span
    if bounds_amp_wave_phase is not None and len(bounds_amp_wave_phase) >= 2:
        lam_min, lam_max = bounds_amp_wave_phase[1]
    wavelengths = np.geomspace(max(lam_min, 1e-9), max(lam_max, lam_min * 1.01), 256)

    resid = y - np.median(y)
    extracted: list[tuple[float, float, float]] = []
    costs = np.full(max_nb_frequency, np.inf)
    params_per_n: list[np.ndarray] = []
    offset = np.median(y)
    for k in range(max_nb_frequency):
        rss, sol = _periodogram_best_wavelength(x, resid, wavelengths)
        best = int(np.argmin(rss))
        A, B, C = sol[best]
        lam = wavelengths[best]
        # a sin(2 pi x / L + phi) = A sin + B cos  =>  phi = atan2(B, A)
        extracted.append((float(np.hypot(A, B)), float(lam), float(np.arctan2(B, A) % (2 * np.pi))))
        resid = resid - (A * np.sin(2 * np.pi * x / lam) + B * np.cos(2 * np.pi * x / lam) + C)
        offset += C
        p_polished = _polish_sumsin(x, y - offset, np.asarray(extracted, dtype=np.float64).ravel())
        params_per_n.append(p_polished)
        costs[k] = cost_func(np.asarray(sumsin_1d(x, *p_polished)) + offset - y)

    p = params_per_n[_choice_best_order(costs)].reshape(-1, 3)
    keep = p[:, 0] > 0.01 * y_amp  # drop near-zero amplitudes
    if keep.any():
        p = p[keep]
    p = p[np.argsort(-p[:, 0])]
    p[:, 2] = p[:, 2] % (2 * np.pi)
    return np.round(p.ravel(), 5), p.shape[0]


def _polish_sumsin(x: np.ndarray, y: np.ndarray, p0: np.ndarray, n_iter: int = 30) -> np.ndarray:
    """Joint LM refinement of sum-of-sines parameters (on the host: a few hundred points at
    most), canonicalised to positive amplitudes and wavelengths without changing the model."""
    yt = as_tensor(y, device="cpu")
    xt = as_tensor(x, device="cpu")
    p, _ = _lm_data(sumsin_1d, xt, yt, 1.0, torch.tensor(p0, dtype=torch.float32, device=yt.device),
                    n_params=len(p0), max_iter=n_iter)
    out = p.double().cpu().numpy()
    #   a sin(2 pi x / L + phi), L < 0  ==  -a sin(2 pi x / |L| - phi)
    #   a sin(... + phi), a < 0         ==  |a| sin(... + phi + pi)
    neg_l = out[1::3] < 0
    out[1::3] = np.abs(out[1::3])
    out[0::3] = np.where(neg_l, -out[0::3], out[0::3])
    out[2::3] = np.where(neg_l, -out[2::3], out[2::3])
    neg_a = out[0::3] < 0
    out[0::3] = np.abs(out[0::3])
    out[2::3] = np.where(neg_a, out[2::3] + np.pi, out[2::3])
    return out
