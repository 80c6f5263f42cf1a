"""Optimizers over (design, gradient) — the reference's NLopt layer.

The port's counterpart of the JAX package's ``adjoint/optimize.py``
(reference ``acOptimize``/``GenericOptimizer::Execute``,
src/Handlers.cpp.Rt:1708-1943, and the built-in descent
``Iteration_Opt``, src/cuda.cu.Rt:224-234).  Methods:

* ``MMA``: Svanberg's Method of Moving Asymptotes (the reference's NLopt
  default, LD_MMA) with the material constraint exact (:func:`_mma`);
* ``LBFGS``: scipy L-BFGS-B (SLSQP with a material constraint);
* ``DESCENT``: clamped steepest descent (``Iteration_Opt``);
* ``ADAM``: Adam written out on tensors.

The optimizers work on float64 numpy copies of the flattened design on
the host; ``grad_fn`` gets and returns tensors in the design's structure,
dtype and device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from tclb_tpu_torch.adjoint.run import leaves, like


def ravel(theta) -> tuple[np.ndarray, Callable]:
    """``theta``'s entries as one float64 numpy vector, and the map back
    to tensors of ``theta``'s structure, dtype and device."""
    parts = leaves(theta)
    flat = np.concatenate([t.detach().cpu().numpy().astype(np.float64)
                           .ravel() for t in parts])
    bounds = np.cumsum([0] + [t.numel() for t in parts])

    def unravel(x: np.ndarray):
        return like(theta, [
            torch.as_tensor(np.asarray(x[a:b]).reshape(t.shape),
                            dtype=t.dtype, device=t.device)
            for a, b, t in zip(bounds[:-1], bounds[1:], parts)])

    return flat, unravel


def _clamp(theta, lo, hi):
    if lo is None and hi is None:
        return theta
    return like(theta, [torch.clamp(t, min=lo, max=hi)
                        for t in leaves(theta)])


def _project_material(theta, lo, hi, direction: str, m0: float,
                      mask=None):
    """Project theta onto ``sum(theta[mask]) >= m0`` ('more') or ``<= m0``
    ('less') intersected with the [lo, hi] box: bisection on a uniform
    shift of the masked entries with re-clipping (the reference's NLopt
    inequality constraints FMaterialMore/FMaterialLess,
    src/Handlers.cpp.Rt:1790-1812, for the projected methods)."""
    flat, unravel = ravel(theta)
    lo_ = -np.inf if lo is None else float(lo)
    hi_ = np.inf if hi is None else float(hi)
    msk = np.ones_like(flat) if mask is None else \
        np.asarray(mask, dtype=np.float64).ravel()
    total = float(flat @ msk)
    if (direction == "more" and total >= m0) or \
            (direction == "less" and total <= m0):
        return theta

    def s(t):
        return float(np.clip(flat + t * msk, lo_, hi_) @ msk)

    t_lo, t_hi = -1.0, 1.0
    for _ in range(60):
        if s(t_lo) <= m0:
            break
        t_lo *= 2.0
    for _ in range(60):
        if s(t_hi) >= m0:
            break
        t_hi *= 2.0
    for _ in range(60):
        tm = 0.5 * (t_lo + t_hi)
        if s(tm) < m0:
            t_lo = tm
        else:
            t_hi = tm
    t = t_hi if direction == "more" else t_lo
    shifted = np.clip(flat + t * msk, lo_, hi_)
    return unravel(np.where(msk > 0, shifted, flat))


def _parse_material(material, n):
    """The ``('more'|'less', m0[, mask])`` material tuple as one linear
    constraint ``a @ x <= b`` ((None, None) when absent)."""
    if material is None:
        return None, None
    direction, m0 = material[0], float(material[1])
    mvec = np.ones(n) if len(material) < 3 else \
        np.asarray(material[2], dtype=np.float64).ravel()
    return (mvec, m0) if direction == "less" else (-mvec, -m0)


def _mma(grad_fn, theta0, max_eval, lo, hi, material, callback):
    """Svanberg's Method of Moving Asymptotes (1987), the reference's
    NLopt default (LD_MMA, src/Handlers.cpp.Rt:1815-1868): each outer
    iteration minimizes the separable convex approximation ``r + sum_j
    p_j/(U_j - x_j) + q_j/(x_j - L_j)`` with moving asymptotes inside move
    limits; the linear material constraint ``a @ x <= b`` is exact (the
    per-coordinate minimizer by vectorized bisection, the one multiplier
    by outer bisection on feasibility).  Returns the best evaluated
    design and its objective."""
    if material is not None:
        # start feasible: every later iterate is
        theta0 = _project_material(theta0, lo, hi, *material)
    x, unravel = ravel(theta0)
    n = x.size
    # unbounded coordinates get a pseudo-box scaled to the start point
    wide = 2.0 * np.maximum(np.abs(x), 1.0)
    xmin = x - wide if lo is None else np.full(n, float(lo))
    xmax = x + wide if hi is None else np.full(n, float(hi))
    x = np.clip(x, xmin, xmax)
    span = np.maximum(xmax - xmin, 1e-12)
    a, b = _parse_material(material, n)
    low = x - 0.5 * span
    upp = x + 0.5 * span
    xold1 = xold2 = x
    best_obj, best_x = np.inf, x

    for k in range(max_eval):
        obj, g = grad_fn(unravel(x))
        gflat = ravel(g)[0]
        if float(obj) < best_obj:
            best_obj, best_x = float(obj), x
        if callback:
            callback(k, float(obj), unravel(x))

        # asymptotes (Svanberg's gamma rule)
        if k < 2:
            low = x - 0.5 * span
            upp = x + 0.5 * span
        else:
            osc = (x - xold1) * (xold1 - xold2)
            gamma = np.where(osc > 0, 1.2, np.where(osc < 0, 0.7, 1.0))
            low = x - gamma * (xold1 - low)
            upp = x + gamma * (upp - xold1)
            low = np.clip(low, x - 10.0 * span, x - 0.01 * span)
            upp = np.clip(upp, x + 0.01 * span, x + 10.0 * span)

        # the separable approximation of the objective
        gp = np.maximum(gflat, 0.0)
        gm = np.maximum(-gflat, 0.0)
        reg = 1e-3 * np.abs(gflat) + 1e-6 / span
        p0 = (upp - x) ** 2 * (1.001 * gp + 0.001 * gm + reg)
        q0 = (x - low) ** 2 * (0.001 * gp + 1.001 * gm + reg)
        alpha = np.maximum(xmin, np.maximum(low + 0.1 * (x - low),
                                            x - 0.5 * span))
        beta = np.minimum(xmax, np.minimum(upp - 0.1 * (upp - x),
                                           x + 0.5 * span))

        def bisect(lam, sl):
            """argmin of the separable Lagrangian on [alpha, beta] over
            the coordinates ``sl`` (its derivative is increasing in x:
            vectorized bisection)."""
            loj, hij = alpha[sl].copy(), beta[sl].copy()
            pj, qj, uj, lj = p0[sl], q0[sl], upp[sl], low[sl]
            aj = None if a is None else a[sl]
            for _ in range(50):
                mid = 0.5 * (loj + hij)
                d = pj / (uj - mid) ** 2 - qj / (mid - lj) ** 2
                if aj is not None:
                    d = d + lam * aj
                up = d < 0.0
                loj = np.where(up, mid, loj)
                hij = np.where(up, hij, mid)
            return 0.5 * (loj + hij)

        # the multiplier moves only the coordinates the constraint weighs
        # (a design's material nodes): bisect the others once
        x_free = bisect(0.0, slice(None))
        weighed = None if a is None else np.flatnonzero(a)

        def xa(lam):
            if a is None or lam == 0.0:
                return x_free
            out = x_free.copy()
            out[weighed] = bisect(lam, weighed)
            return out

        if a is None or float(a @ xa(0.0)) <= b:
            x_new = xa(0.0)
        else:
            lam_hi = 1.0
            for _ in range(60):
                if float(a @ xa(lam_hi)) <= b:
                    break
                lam_hi *= 2.0
            lam_lo = 0.0
            for _ in range(60):
                lam = 0.5 * (lam_lo + lam_hi)
                if float(a @ xa(lam)) <= b:
                    lam_hi = lam
                else:
                    lam_lo = lam
            x_new = xa(lam_hi)
        xold2, xold1, x = xold1, x, x_new

    return unravel(best_x), best_obj


def batched_descent(evaluate: Callable, theta0: Any, max_iter: int = 10,
                    steps: tuple = (0.25, 0.5, 1.0, 2.0),
                    bounds: tuple = (None, None),
                    callback: Optional[Callable] = None
                    ) -> tuple[Any, float]:
    """Projected steepest descent whose line search is one batched
    evaluation per iteration: ``evaluate(thetas) -> [(objective, grad),
    ...]`` values the whole fan ``theta - s * g`` over the trial steps at
    once; the best candidate's gradient seeds the next fan, and when none
    improves the steps halve.  Returns ``(theta_best, objective_best)``."""
    lo, hi = bounds if isinstance(bounds, tuple) and len(bounds) == 2 \
        else (None, None)
    width = max(1, len(steps))
    out = evaluate([theta0] * width)
    obj, g = float(out[0][0]), out[0][1]
    theta, scale = theta0, 1.0
    best_obj, best_theta = obj, theta0
    if callback:
        callback(0, obj, theta0)
    for k in range(max_iter):
        cands = [_clamp(like(theta, [t - scale * s * d for t, d in
                                     zip(leaves(theta), leaves(g))]),
                        lo, hi) for s in steps]
        out = evaluate(cands)
        objs = [float(o) for o, _ in out]
        i = int(np.argmin(objs))
        if objs[i] < obj:
            theta, obj, g = cands[i], objs[i], out[i][1]
            scale = 1.0
        else:
            scale *= 0.5
        if obj < best_obj:
            best_obj, best_theta = obj, theta
        if callback:
            callback(k + 1, obj, theta)
    return best_theta, best_obj


def _adam(grad_fn, theta0, max_eval, step, feasible, lo, hi, callback,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam (Kingma & Ba) with optax.adam's defaults, projected onto the
    bounds and the material constraint after each update."""
    theta = feasible(theta0)
    m = [torch.zeros_like(t) for t in leaves(theta)]
    v = [torch.zeros_like(t) for t in leaves(theta)]
    obj = np.inf
    for k in range(max_eval):
        obj, g = grad_fn(theta)
        new = []
        for i, (t, d) in enumerate(zip(leaves(theta), leaves(g))):
            m[i] = b1 * m[i] + (1 - b1) * d
            v[i] = b2 * v[i] + (1 - b2) * d * d
            mhat = m[i] / (1 - b1 ** (k + 1))
            vhat = v[i] / (1 - b2 ** (k + 1))
            new.append(t - step * mhat / (torch.sqrt(vhat) + eps))
        theta = feasible(_clamp(like(theta, new), lo, hi))
        if callback:
            callback(k, float(obj), theta)
    return theta, float(obj)


def optimize(grad_fn: Callable, theta0: Any, method: str = "MMA",
             max_eval: int = 20, step: float = 1.0,
             bounds: tuple = (None, None),
             callback: Optional[Callable] = None,
             material: Optional[tuple] = None) -> tuple[Any, float]:
    """Minimize the objective over theta: ``grad_fn(theta) -> (objective,
    grad)``; returns ``(theta_opt, best_objective)``.  ``callback(k, obj,
    theta)`` fires per evaluation.  ``material=('more'|'less', m0[,
    mask])`` keeps ``sum(theta * mask)`` above or below ``m0`` (reference
    <Optimize Material="more|less">, src/Handlers.cpp.Rt:1776-1812):
    projection for the descent methods, exact in MMA, SLSQP constraints
    for the quasi-Newton path."""
    method = method.upper()
    lo, hi = bounds if isinstance(bounds, tuple) and len(bounds) == 2 \
        else (None, None)

    def feasible(theta):
        if material is None:
            return theta
        return _project_material(theta, lo, hi, *material)

    if method in ("DESCENT", "STEEPEST"):
        theta = feasible(theta0)
        obj = np.inf
        for k in range(max_eval):
            obj, g = grad_fn(theta)
            theta = feasible(_clamp(like(theta, [
                t - step * d for t, d in zip(leaves(theta), leaves(g))]),
                lo, hi))
            if callback:
                callback(k, float(obj), theta)
        return theta, float(obj)
    if method == "ADAM":
        return _adam(grad_fn, theta0, max_eval, step, feasible, lo, hi,
                     callback)
    if method == "MMA":
        return _mma(grad_fn, theta0, max_eval, lo, hi, material, callback)
    if method in ("LBFGS", "L-BFGS-B"):
        from scipy.optimize import minimize
        flat0, unravel = ravel(theta0)

        def f_and_g(x):
            obj, g = grad_fn(unravel(x))
            if callback:
                f_and_g.k += 1
                callback(f_and_g.k, float(obj), unravel(x))
            return float(obj), ravel(g)[0]

        f_and_g.k = 0
        b = None
        if lo is not None or hi is not None:
            b = [(lo, hi)] * flat0.size
        if material is not None:
            a_c, b_c = _parse_material(material, flat0.size)
            cons = [{"type": "ineq",
                     "fun": lambda x: b_c - float(x @ a_c),
                     "jac": lambda x: -a_c}]
            res = minimize(f_and_g, flat0, jac=True, method="SLSQP",
                           bounds=b, constraints=cons,
                           options={"maxiter": max_eval})
        else:
            res = minimize(f_and_g, flat0, jac=True, method="L-BFGS-B",
                           bounds=b, options={"maxfun": max_eval})
        return unravel(res.x), float(res.fun)
    raise ValueError(f"unknown optimization method {method!r}")
