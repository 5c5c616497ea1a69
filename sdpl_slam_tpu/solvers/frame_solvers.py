"""Per-frame joint flow+pose / flow+object-motion solvers as batched LM.

Array re-design of the reference's per-frame g2o graphs
(/root/reference/src/Optimizer.cc:6409 ``PoseOptimizationFlow2CamWithLines``,
:7603 ``PoseOptimizationFlow2withLines``).  The reference builds, per frame,
a graph with ONE SE(3) vertex and one marginalized 2-dof flow vertex per
point (4-dof per line) and runs g2o Levenberg-Marquardt for 100 iterations.

Because every flow vertex touches only the pose, the Schur complement is
closed-form: each feature contributes a 2x2 (points) or 4x4 (lines) block
inverse, reduced into a single damped 6x6 system.  All features are
processed as fixed-capacity batched tensors with validity masks -- no graph
construction, no sparse bookkeeping; every LM iteration is a handful of
fused XLA kernels (einsum reductions onto the 6x6 system).

Edge semantics replicated exactly (citations into /root/reference):

* ``EdgeSE3ProjectFlow2``  (types_six_dof_expmap.h:603-645):
  r = (obs + flow) - pi(T . (R_wl pi^-1(obs, z) + t_wl)),  info 0.1*I2,
  Huber delta = sqrt(rp_thres), rp_thres = 0.04 (Optimizer.cc:6411,6456).
* ``EdgeFlowPrior`` (:561-578): r = flow - flow_pwc, info 0.3*I2 for the
  camera solver (Optimizer.cc:6305), 0.5*I2 for the object solver (:7491).
* ``EdgeSE3ProjectFlow2_Line2`` (types_six_dof_expmap.h:648-765): with
  P,Q = flow-shifted last-frame endpoints and l = (P x Q)/|P x Q| the
  image line, the *intended* residual is [l . hp, l . hq] where hp,hq are
  homogeneous projections of the unprojected endpoints through the pose.
  The reference's ``computeError`` computes the second component as
  l . Q  which is identically zero by construction, while its
  ``linearizeOplus`` uses the Jacobians of the intended residual -- so the
  second row contributes curvature (H) but no gradient (b).  We replicate
  that effective behavior: residual vector [e0, 0] with both Jacobian rows.
  Info 0.1*I2 (Optimizer.cc:6586), Huber delta_line = sqrt(W*7.815) with
  W = 2^-(n_points//100)  (Optimizer.cc:6540-6543).
* ``EdgeFlowPriorLine`` (:581-600): info 0.3*I4 camera / 0.5*I4 object.

Post-solve gating (Optimizer.cc:6681-6782): point chi2 > rp_thres marks the
feature outlier (TemperalMatch = -1 downstream); the line threshold
W*7.815 is recomputed from the post-fit point-inlier count.  Inlier
keypoints are advanced to ``last + optimized_flow`` (Optimizer.cc:6796-6833).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import geometry, lie
from ..ops.geometry import Intrinsics

_HI = jax.lax.Precision.HIGHEST


class PointBundle(NamedTuple):
    """Fixed-capacity batch of tracked points for one solve.

    obs   : (N, 2) last-frame pixels (the edge measurement)
    flow0 : (N, 2) measured optical flow (PWC-Net), the prior
    depth : (N,)   last-frame depth at obs
    valid : (N,)   bool mask
    """

    obs: jnp.ndarray
    flow0: jnp.ndarray
    depth: jnp.ndarray
    valid: jnp.ndarray


class LineBundle(NamedTuple):
    """Fixed-capacity batch of tracked line segments.

    obs   : (M, 4) last-frame endpoints (sx, sy, ex, ey)
    flow0 : (M, 4) endpoint flows
    depth : (M, 2) endpoint depths
    valid : (M,)   bool mask
    """

    obs: jnp.ndarray
    flow0: jnp.ndarray
    depth: jnp.ndarray
    valid: jnp.ndarray


class FlowPoseResult(NamedTuple):
    pose: jnp.ndarray           # (4,4) optimized T (camera T_cw, or object G)
    flow: jnp.ndarray           # (N,2) optimized point flows
    line_flow: jnp.ndarray      # (M,4) optimized line endpoint flows
    point_inlier: jnp.ndarray   # (N,) bool (valid & chi2 <= rp_thres)
    line_inlier: jnp.ndarray    # (M,) bool
    n_iters: jnp.ndarray        # LM iterations executed
    final_cost: jnp.ndarray     # robustified total chi2


def _huber_weight(chi2: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """g2o RobustKernelHuber first derivative rho'(chi2): 1 inside,
    delta/sqrt(chi2) outside."""
    safe = jnp.maximum(chi2, 1e-20)
    return jnp.where(chi2 <= delta * delta, 1.0, delta / jnp.sqrt(safe))


def _huber_rho(chi2: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """g2o RobustKernelHuber rho(chi2) for the total cost."""
    safe = jnp.maximum(chi2, 1e-20)
    return jnp.where(
        chi2 <= delta * delta,
        chi2,
        2.0 * delta * jnp.sqrt(safe) - delta * delta,
    )


def _point_proj_jacobian(xyz: jnp.ndarray, fx, fy) -> jnp.ndarray:
    """d[(obs+f) - pi(T X)]/d(delta_xi) at delta=0, [omega, v] order --
    the closed form in EdgeSE3ProjectFlow2::linearizeOplus
    (types_six_dof_expmap.cpp:1008-1040).  xyz: (N, 3) camera-frame points.
    Returns (N, 2, 6)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-6, jnp.full_like(z, 1e-6), z)
    z2 = z * z
    row_u = jnp.stack(
        [x * y / z2 * fx, -(1.0 + x * x / z2) * fx, y / z * fx,
         -1.0 / z * fx, jnp.zeros_like(x), x / z2 * fx],
        axis=-1,
    )
    row_v = jnp.stack(
        [(1.0 + y * y / z2) * fy, -x * y / z2 * fy, -x / z * fy,
         jnp.zeros_like(x), -1.0 / z * fy, y / z2 * fy],
        axis=-1,
    )
    return jnp.stack([row_u, row_v], axis=-2)


def _line_residual_intended(dxi, g, obs4, Xw_s, Xw_e, K, T):
    """The *intended* 2-vector line residual [l.hp, l.hq] (see module doc);
    used for Jacobians.  Single line."""
    Tc = lie.se3_exp(dxi) @ T
    ps = geometry.project(K, lie.transform_point(Tc, Xw_s))
    pe = geometry.project(K, lie.transform_point(Tc, Xw_e))
    P = obs4[:2] + g[:2]
    Q = obs4[2:] + g[2:]
    l = geometry.infinite_line_image(P, Q)
    return jnp.stack(
        [geometry.point_to_image_line(ps, l), geometry.point_to_image_line(pe, l)]
    )


def _line_flow_part(g, obs4, ps, pe):
    """The residual as a function of the 4-dof flow only (projections
    fixed): the cheap jacfwd target for J_g."""
    P = obs4[:2] + g[:2]
    Q = obs4[2:] + g[2:]
    l = geometry.infinite_line_image(P, Q)
    return jnp.stack(
        [geometry.point_to_image_line(ps, l), geometry.point_to_image_line(pe, l)]
    )


def _line_jacobians(g, obs4, xyz_s, xyz_e, ps, pe, l, K):
    """Closed-form J_xi + small-jacfwd J_g of the intended line residual.

    J_xi rows are l_2d . d(proj)/d(xi) -- the reference's analytic structure
    (types_six_dof_expmap.cpp:1190-1200 ``der_e_xi = line * der_proj``);
    d(proj)/d(xi) is the standard SE3 projection Jacobian (the NEGATIVE of
    :func:`_point_proj_jacobian`, which carries the (obs - pi) sign).
    Batched over lines.
    """
    Jp_s = -_point_proj_jacobian(xyz_s, K.fx, K.fy)     # (M, 2, 6) d proj/d xi
    Jp_e = -_point_proj_jacobian(xyz_e, K.fx, K.fy)
    l2 = l[..., :2]                                     # (M, 2)
    row0 = jnp.einsum("mk,mki->mi", l2, Jp_s, precision=_HI)
    row1 = jnp.einsum("mk,mki->mi", l2, Jp_e, precision=_HI)
    Jlx = jnp.stack([row0, row1], axis=1)               # (M, 2, 6)
    Jlg = jax.vmap(jax.jacfwd(_line_flow_part))(g, obs4, ps, pe)  # (M, 2, 4)
    return Jlx, Jlg


def inject_depth_noise(key: jax.Array, z: jnp.ndarray) -> jnp.ndarray:
    """Gaussian depth-noise injection used by the non-joint solvers when
    ``addnoise=1`` (Frame::UnprojectStereoStat, /root/reference/src/
    Frame.cc:1140-1150): sigma = z^2 / (725 * 0.5) * 0.15."""
    sigma = z * z / (725.0 * 0.5) * 0.15
    return z + sigma * jax.random.normal(key, z.shape, z.dtype)


class PoseOnlyResult(NamedTuple):
    pose: jnp.ndarray
    point_inlier: jnp.ndarray
    line_inlier: jnp.ndarray
    final_cost: jnp.ndarray


def solve_pose_only(
    T_init: jnp.ndarray,
    X_w: jnp.ndarray,          # (N, 3) fixed 3D (world) from the last frame
    obs_uv: jnp.ndarray,       # (N, 2) CURRENT 2D observations
    valid: jnp.ndarray,
    line_Xs: jnp.ndarray,      # (M, 3) line endpoint 3D (world)
    line_Xe: jnp.ndarray,
    line_coeffs: jnp.ndarray,  # (M, 3) measured infinite-line coefficients
    line_valid: jnp.ndarray,
    K: Intrinsics,
    rp_thres: float = 0.01,
    line_weight_thr: int = 50,
    use_lines: bool = True,
) -> PoseOnlyResult:
    """``PoseOptimizationNew(WithLines)`` / ``PoseOptimizationObjMot...``
    (/root/reference/src/Optimizer.cc:5742/:5900/:6843/:7055): pose-only
    (or motion-only) LM on fixed 3D structure.

    Residuals: r_p = obs - pi(T X_w) (info I, Huber sqrt(rp_thres));
    r_l = [l . h(pi(T Xs)), l . h(pi(T Xe))] with the measured current
    infinite line l (info I, Huber sqrt(W*7.815), W = 2^-(n//50)).
    Four gating rounds of {100,10,10,10} iterations with chi2 thresholds
    {rp_thres, 5.991, 5.991, 5.991} (Optimizer.cc:5832,6080); outliers are
    excluded per round and may re-enter.
    """
    dtype = X_w.dtype
    n_valid0 = jnp.sum(valid.astype(jnp.int32))
    weight = jnp.power(
        2.0, -(n_valid0 // line_weight_thr).astype(dtype)
    )
    delta_line = jnp.sqrt(weight * 7.815)
    delta_mono = jnp.asarray(jnp.sqrt(rp_thres), dtype)
    lvalid0 = line_valid & jnp.asarray(use_lines)

    def residuals(T):
        xyz = lie.transform_point(T, X_w)
        r_p = obs_uv - geometry.project(K, xyz)
        chi2_p = jnp.sum(r_p * r_p, axis=-1)
        ps = geometry.project(K, lie.transform_point(T, line_Xs))
        pe = geometry.project(K, lie.transform_point(T, line_Xe))
        r_l = jnp.stack(
            [
                geometry.point_to_image_line(ps, line_coeffs),
                geometry.point_to_image_line(pe, line_coeffs),
            ],
            axis=-1,
        )
        r_l = jnp.nan_to_num(r_l)
        chi2_l = jnp.sum(r_l * r_l, axis=-1)
        return r_p, chi2_p, r_l, chi2_l, xyz

    def lm_round(T, active_p, active_l, iters):
        pv = (valid & active_p).astype(dtype)
        lv = (lvalid0 & active_l).astype(dtype)

        def cost_fn(Tc):
            r_p, chi2_p, r_l, chi2_l, _ = residuals(Tc)
            return (
                jnp.sum(pv * _huber_rho(chi2_p, delta_mono))
                + jnp.sum(lv * _huber_rho(chi2_l, delta_line))
            )

        def line_res_fn(dxi, Tc):
            T2 = lie.se3_exp(dxi) @ Tc
            ps = geometry.project(K, lie.transform_point(T2, line_Xs))
            pe = geometry.project(K, lie.transform_point(T2, line_Xe))
            return jnp.stack(
                [
                    geometry.point_to_image_line(ps, line_coeffs),
                    geometry.point_to_image_line(pe, line_coeffs),
                ],
                axis=-1,
            )

        def body(state, _):
            T, lam, nu, cost = state
            r_p, chi2_p, r_l, chi2_l, xyz = residuals(T)
            w_p = pv * _huber_weight(chi2_p, delta_mono)
            w_l = lv * _huber_weight(chi2_l, delta_line)
            Jp = _point_proj_jacobian(xyz, K.fx, K.fy)
            # r_p = obs - pi: same sign convention as the flow edge
            Jl = jax.jacfwd(line_res_fn)(jnp.zeros(6, dtype), T)
            Jl = jnp.nan_to_num(Jl)                        # (M, 2, 6)
            H = (
                jnp.einsum("nki,nkj,n->ij", Jp, Jp, w_p, precision=_HI)
                + jnp.einsum("mki,mkj,m->ij", Jl, Jl, w_l, precision=_HI)
            )
            b = -(
                jnp.einsum("nki,nk,n->i", Jp, r_p, w_p, precision=_HI)
                + jnp.einsum("mki,mk,m->i", Jl, r_l, w_l, precision=_HI)
            )
            dxi = jnp.linalg.solve(H + lam * jnp.eye(6, dtype=dtype), b)
            T_new = lie.se3_retract(T, dxi)
            new_cost = cost_fn(T_new)
            accept = (new_cost < cost) & jnp.isfinite(new_cost)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (
                jnp.where(accept, T_new, T),
                lam, nu,
                jnp.where(accept, new_cost, cost),
            ), None

        state0 = (T, jnp.asarray(1e-4, dtype), jnp.asarray(2.0, dtype),
                  cost_fn(T))
        (T, _, _, cost), _ = jax.lax.scan(body, state0, None, length=iters)
        return T, cost

    T = T_init
    chi2_gate = [rp_thres, 5.991, 5.991, 5.991]
    its = [100, 10, 10, 10]
    active_p = jnp.ones_like(valid)
    active_l = jnp.ones_like(line_valid)
    cost = jnp.asarray(0.0, dtype)
    for rnd in range(4):
        T, cost = lm_round(T, active_p, active_l, its[rnd])
        _, chi2_p, _, chi2_l, _ = residuals(T)
        active_p = chi2_p <= chi2_gate[rnd]
        active_l = chi2_l <= weight * 7.815
    return PoseOnlyResult(
        # project the iterated f32 composition chain back onto SE(3):
        # without this, orthonormality drift accumulates across frames and
        # the reference's clamped-trace rotation metric reads it as error
        # (see lie.so3_orthonormalize)
        pose=lie.se3_orthonormalize(T),
        point_inlier=valid & active_p,
        line_inlier=lvalid0 & active_l,
        final_cost=cost,
    )


class _LMState(NamedTuple):
    T: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    lam: jnp.ndarray
    nu: jnp.ndarray
    cost: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def solve_flow_pose(
    T_init: jnp.ndarray,
    T_wl: jnp.ndarray,
    points: PointBundle,
    lines: LineBundle,
    K: Intrinsics,
    rp_thres: float = 0.04,
    proj_info: float = 0.1,
    flow_prior_info: float = 0.5,
    line_proj_info: float = 0.1,
    line_prior_info: float = 0.5,
    line_weight_thr: int = 100,
    max_iterations: int = 100,
    use_lines: bool = True,
    rel_tol: float = 1e-7,
) -> FlowPoseResult:
    """Joint flow+pose LM with closed-form Schur elimination of flows.

    For the camera: ``T_init`` = initial T_cw, ``T_wl`` = inv(last T_cw),
    flow_prior_info = 0.3 (Optimizer.cc:6305).  For an object: ``T_init`` =
    the propagated motion model G in camera coords, ``T_wl`` = inv(last
    T_cw), flow_prior_info = 0.5 (Optimizer.cc:7491).  The math is shared;
    only inputs and constants differ (the reference duplicates ~400 lines
    per variant).
    """
    n_pts = points.obs.shape[0]
    n_lin = lines.obs.shape[0]
    dtype = points.obs.dtype

    pvalid = points.valid.astype(dtype)
    lvalid = lines.valid.astype(dtype) * (1.0 if use_lines else 0.0)

    # Constant unprojections through the last pose (module doc: the edge
    # reprojects the LAST-frame pixel unprojected at its depth).
    Xw = lie.transform_point(T_wl, geometry.backproject(K, points.obs, points.depth))
    Xw_s = lie.transform_point(
        T_wl, geometry.backproject(K, lines.obs[:, :2], lines.depth[:, 0])
    )
    Xw_e = lie.transform_point(
        T_wl, geometry.backproject(K, lines.obs[:, 2:], lines.depth[:, 1])
    )

    delta_mono = jnp.asarray(jnp.sqrt(rp_thres), dtype)
    # W = 2^-(n_initial_points // thr), integer division (Optimizer.cc:6540).
    n_init_pts = jnp.sum(points.valid.astype(jnp.int32))
    weight0 = jnp.power(2.0, -(n_init_pts // line_weight_thr).astype(dtype))
    delta_line0 = jnp.sqrt(weight0 * 7.815)

    def line_parts(T, g):
        xyz_s = lie.transform_point(T, Xw_s)
        xyz_e = lie.transform_point(T, Xw_e)
        ps = geometry.project(K, xyz_s)
        pe = geometry.project(K, xyz_e)
        P = lines.obs[:, :2] + g[:, :2]
        Q = lines.obs[:, 2:] + g[:, 2:]
        l = geometry.infinite_line_image(P, Q)
        e0 = geometry.point_to_image_line(ps, l)
        return xyz_s, xyz_e, ps, pe, l, e0

    def residuals_and_cost(T, f, g, delta_line):
        """Total robustified cost + per-edge chi2 (for gating)."""
        xyz = lie.transform_point(T, Xw)
        r_p = (points.obs + f) - geometry.project(K, xyz)      # (N,2)
        chi2_p = proj_info * jnp.sum(r_p * r_p, axis=-1)
        r_f = f - points.flow0
        chi2_f = flow_prior_info * jnp.sum(r_f * r_f, axis=-1)

        # reference quirk: second component identically zero in the error;
        # invalid padded lines hard-zeroed (0 * NaN would poison the cost)
        _, _, _, _, _, e0 = line_parts(T, g)
        r_l = jnp.stack([e0, jnp.zeros_like(e0)], axis=-1)
        r_l = jnp.where(lines.valid[:, None], jnp.nan_to_num(r_l), 0.0)
        chi2_l = line_proj_info * jnp.sum(r_l * r_l, axis=-1)
        r_g = g - lines.flow0
        chi2_g = line_prior_info * jnp.sum(r_g * r_g, axis=-1)

        cost = (
            jnp.sum(pvalid * (_huber_rho(chi2_p, delta_mono) + chi2_f))
            + jnp.sum(lvalid * (_huber_rho(chi2_l, delta_line) + chi2_g))
        )
        return cost, (r_p, r_f, chi2_p, r_l, r_g, chi2_l)

    def build_and_solve(T, f, g, lam, delta_line):
        """One damped-GN (LM trial) step; returns (dxi, df, dg, gain_den)."""
        cost, (r_p, r_f, chi2_p, r_l, r_g, chi2_l) = residuals_and_cost(
            T, f, g, delta_line
        )

        # --- points ---
        xyz = lie.transform_point(T, Xw)
        Jx = _point_proj_jacobian(xyz, K.fx, K.fy)                # (N,2,6)
        w_p = pvalid * _huber_weight(chi2_p, delta_mono) * proj_info
        w_f = pvalid * flow_prior_info
        # J_f = I2.  Blocks:
        # Hxx += w_p Jx^T Jx ; Hxf_i = w_p Jx^T ; Hff_i = w_p I + w_f I + lam I
        Hxx_p = jnp.einsum("nki,nkj,n->ij", Jx, Jx, w_p, precision=_HI)
        bx_p = -jnp.einsum("nki,nk,n->i", Jx, r_p, w_p, precision=_HI)
        hff = w_p + w_f + lam                                      # (N,)
        hff = jnp.where(points.valid, hff, 1.0)
        inv_hff = 1.0 / hff
        bf = -(w_p[:, None] * r_p + w_f[:, None] * r_f)            # (N,2)
        # Hxf_i = w_p Jx_i^T (2x6)^T -> (6,2); Schur: Hxf inv_hff Hxf^T
        Hxf = jnp.einsum("nki,n->nik", Jx, w_p, precision=_HI)     # (N,6,2)
        Hxx_p_schur = jnp.einsum(
            "nik,njk,n->ij", Hxf, Hxf, inv_hff, precision=_HI
        )
        bx_p_schur = jnp.einsum("nik,nk,n->i", Hxf, bf, inv_hff, precision=_HI)

        # --- lines ---
        xyz_s, xyz_e, ps, pe, l_img, _ = line_parts(T, g)
        (Jlx, Jlg) = _line_jacobians(
            g, lines.obs, xyz_s, xyz_e, ps, pe, l_img, K
        )
        # (M,2,6), (M,2,4); residual for b has zeroed 2nd component.
        # Hard-zero invalid lines: padding may produce non-finite Jacobians
        # and 0 * NaN would poison the reductions.
        lmask = lines.valid[:, None, None]
        Jlx = jnp.where(lmask, jnp.nan_to_num(Jlx), 0.0)
        Jlg = jnp.where(lmask, jnp.nan_to_num(Jlg), 0.0)
        w_l = lvalid * _huber_weight(chi2_l, delta_line) * line_proj_info
        w_g = lvalid * line_prior_info
        Hxx_l = jnp.einsum("mki,mkj,m->ij", Jlx, Jlx, w_l, precision=_HI)
        bx_l = -jnp.einsum("mki,mk,m->i", Jlx, r_l, w_l, precision=_HI)
        # Hgg_i = w_l Jlg^T Jlg + (w_g + lam) I4   (4x4)
        Hgg = jnp.einsum("mki,mkj,m->mij", Jlg, Jlg, w_l, precision=_HI)
        Hgg = Hgg + (w_g + lam)[:, None, None] * jnp.eye(4, dtype=dtype)
        Hgg = jnp.where(
            lines.valid[:, None, None], Hgg,
            jnp.broadcast_to(jnp.eye(4, dtype=dtype), Hgg.shape),
        )
        bg = -(
            jnp.einsum("mki,mk,m->mi", Jlg, r_l, w_l, precision=_HI)
            + w_g[:, None] * r_g
        )
        Hxg = jnp.einsum("mki,mkj,m->mij", Jlx, Jlg, w_l, precision=_HI)  # (M,6,4)
        inv_Hgg = jnp.linalg.inv(Hgg)
        Hxx_l_schur = jnp.einsum(
            "mik,mkl,mjl->ij", Hxg, inv_Hgg, Hxg, precision=_HI
        )
        bx_l_schur = jnp.einsum("mik,mkl,ml->i", Hxg, inv_Hgg, bg, precision=_HI)

        Hxx = Hxx_p + Hxx_l + lam * jnp.eye(6, dtype=dtype)
        Hxx = Hxx - Hxx_p_schur - Hxx_l_schur
        bx = bx_p + bx_l - bx_p_schur - bx_l_schur

        dxi = jnp.linalg.solve(Hxx, bx)
        df = inv_hff[:, None] * (bf - jnp.einsum("nik,i->nk", Hxf, dxi, precision=_HI))
        dg = jnp.einsum(
            "mij,mj->mi", inv_Hgg,
            bg - jnp.einsum("mik,i->mk", Hxg, dxi, precision=_HI),
            precision=_HI,
        )
        # LM gain denominator: delta^T (lam*delta + b) over all variables.
        gain_den = (
            dxi @ (lam * dxi + bx)
            + jnp.sum(pvalid[:, None] * df * (lam * df + bf))
            + jnp.sum(lvalid[:, None] * dg * (lam * dg + bg))
        )
        return cost, dxi, df, dg, gain_den

    def initial_lambda():
        """g2o: lambda0 = tau * max(diag(H)), tau = 1e-5, where H carries the
        robustified (Huber-weighted) information like g2o's linear system."""
        xyz = lie.transform_point(T_init, Xw)
        r_p = (points.obs + points.flow0) - geometry.project(K, xyz)
        chi2_p = proj_info * jnp.sum(r_p * r_p, axis=-1)
        w_p = pvalid * _huber_weight(chi2_p, delta_mono) * proj_info
        Jx = _point_proj_jacobian(xyz, K.fx, K.fy)
        diag = jnp.einsum("nki,nki,n->i", Jx, Jx, w_p, precision=_HI)
        return 1e-5 * jnp.maximum(jnp.max(diag), 1e-3)

    f0 = points.flow0
    g0 = lines.flow0

    def cond(s: _LMState):
        return (s.it < max_iterations) & (~s.done)

    def body(s: _LMState):
        cost, dxi, df, dg, gain_den = build_and_solve(
            s.T, s.f, s.g, s.lam, delta_line0
        )
        T_new = lie.se3_retract(s.T, dxi)
        f_new = s.f + df
        g_new = s.g + dg
        new_cost, _ = residuals_and_cost(T_new, f_new, g_new, delta_line0)
        rho = (cost - new_cost) / jnp.maximum(gain_den, 1e-12)
        accept = (rho > 0) & jnp.isfinite(new_cost)

        lam_acc = s.lam * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        lam = jnp.where(accept, lam_acc, s.lam * s.nu)
        nu = jnp.where(accept, 2.0, s.nu * 2.0)
        # converged: accepted step with tiny relative improvement, or the
        # trust region has collapsed (accepted-step size fell below noise)
        step_sq = dxi @ dxi
        done = (
            accept & ((cost - new_cost) < rel_tol * jnp.maximum(cost, 1.0))
        ) | (accept & (step_sq < 1e-16)) | (lam > 1e30)
        return _LMState(
            T=jnp.where(accept, T_new, s.T),
            f=jnp.where(accept, f_new, s.f),
            g=jnp.where(accept, g_new, s.g),
            lam=lam,
            nu=nu,
            cost=jnp.where(accept, new_cost, s.cost),
            it=s.it + 1,
            done=done,
        )

    cost0, _ = residuals_and_cost(T_init, f0, g0, delta_line0)
    # an empty problem (all-padding vmap lane) can never accept a step ->
    # without this it would spin the full iteration budget and, under vmap,
    # stall every other lane with it
    empty = (jnp.sum(pvalid) + jnp.sum(lvalid)) < 1.0
    state = _LMState(
        T=T_init, f=f0, g=g0,
        lam=initial_lambda(), nu=jnp.asarray(2.0, dtype),
        cost=cost0, it=jnp.asarray(0, jnp.int32),
        done=empty,
    )
    state = jax.lax.while_loop(cond, body, state)

    # --- outlier gating (Optimizer.cc:6681-6782) ---
    _, (r_p, _, chi2_p, r_l, _, chi2_l) = residuals_and_cost(
        state.T, state.f, state.g, delta_line0
    )
    point_inlier = points.valid & (chi2_p <= rp_thres)
    n_point_inliers = jnp.sum(point_inlier.astype(jnp.int32))
    weight1 = jnp.power(2.0, -(n_point_inliers // line_weight_thr).astype(dtype))
    chi2_line_thr = weight1 * 7.815
    line_inlier = lines.valid & (chi2_l <= chi2_line_thr) & (
        jnp.asarray(use_lines)
    )

    return FlowPoseResult(
        # SE(3) projection of the LM composition chain (lie.so3_orthonormalize
        # doc): keeps frame-chained poses orthonormal so the clamped-trace
        # RPE metric measures rotation, not f32 drift
        pose=lie.se3_orthonormalize(state.T),
        flow=state.f,
        line_flow=state.g,
        point_inlier=point_inlier,
        line_inlier=line_inlier,
        n_iters=state.it,
        final_cost=state.cost,
    )
