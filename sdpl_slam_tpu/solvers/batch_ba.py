"""Batch bundle adjustment: the g2o back-end replacement.

Array re-design of ``FullBatchOptimizationWithLines`` / ``PartialBatch...``
(/root/reference/src/Optimizer.cc:3876 / :1235).  The reference builds a
g2o hyper-graph and runs LM with CSparse; here every edge TYPE is a padded
tensor stack and the normal equations are solved matrix-free with
block-Jacobi-preconditioned conjugate gradients:

 * per-edge residuals and Jacobians (w.r.t. each connected vertex's local
   delta) are computed by ``vmap(jacfwd)`` -- small fixed-size blocks;
 * Hessian-vector products are gather -> einsum -> scatter-add, which XLA
   fuses and which shards trivially over the edge axis for multi-chip BA;
 * the robust (Huber) weights are frozen per outer LM iteration (IRLS).

Graph recipe replicated from Optimizer.cc:3995-5337 (citations inline):

 vertices: camera poses T_wc (VertexSE3), object motions H per object per
   frame (VertexSE3; init Identity in the full BA, :4640; init current
   estimate in the partial BA, :447), static 3D points (one per track),
   static lines (orthonormal 4-dof, one per track), dynamic points/lines
   (one vertex PER OBSERVATION, chained by ternary motion edges).
 edges (information = I/sigma^2, Huber deltas 1e-4, :4013-4018,4038):
   EdgeSE3Prior on frame 0 (info 1e5, :4057), EdgeSE3 odometry
   (meas vmRigidMotion[i-1][0], sigma2_cam=0.001), EdgeSE3PointXYZ
   (r = T_cw X_w - Xc_meas, sigma2=80), EdgeSE3OrthoLine (endpoint-to-
   Pluecker distances, 2-dof), motion smoothness EdgeSE3(meas=I,
   sigma2=0.001), LandmarkMotionTernaryEdge (r = x_prev - H^-1 x_cur,
   sigma2=100), LineLandmarkMotionTernaryEdge (reciprocal-product line
   distance + direction angle, 2-dof).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry, lie

_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Graph container (padded, static shapes once built)
# ---------------------------------------------------------------------------


class BAGraph(NamedTuple):
    cam_T0: jnp.ndarray            # (F, 4, 4) initial T_wc
    cam_valid: jnp.ndarray         # (F,)
    prior_frame: jnp.ndarray       # () int32
    prior_meas: jnp.ndarray        # (4, 4)
    prior_info: jnp.ndarray        # () float

    odo_i: jnp.ndarray             # (Eo,) int32
    odo_j: jnp.ndarray
    odo_meas: jnp.ndarray          # (Eo, 4, 4)
    odo_valid: jnp.ndarray

    mot_T0: jnp.ndarray            # (M, 4, 4)
    mot_valid: jnp.ndarray
    smo_i: jnp.ndarray             # (Es,) motion smoothness pairs
    smo_j: jnp.ndarray
    smo_valid: jnp.ndarray

    Xs0: jnp.ndarray               # (Ps, 3) static points (world)
    Xs_valid: jnp.ndarray
    sp_cam: jnp.ndarray            # (Esp,)
    sp_pt: jnp.ndarray
    sp_meas: jnp.ndarray           # (Esp, 3) camera-frame measurement
    sp_valid: jnp.ndarray

    Ls_U0: jnp.ndarray             # (Pl, 3, 3) static line orthonormal U
    Ls_w0: jnp.ndarray             # (Pl, 2)
    Ls_valid: jnp.ndarray
    sl_cam: jnp.ndarray            # (Esl,)
    sl_line: jnp.ndarray
    sl_meas: jnp.ndarray           # (Esl, 6) camera-frame endpoints
    sl_valid: jnp.ndarray

    Xd0: jnp.ndarray               # (Pd, 3) dynamic point vertices (world)
    Xd_valid: jnp.ndarray
    dp_cam: jnp.ndarray            # (Edp,)
    dp_pt: jnp.ndarray
    dp_meas: jnp.ndarray
    dp_valid: jnp.ndarray
    tern_prev: jnp.ndarray         # (Et,) dyn point vertex ids
    tern_cur: jnp.ndarray
    tern_mot: jnp.ndarray          # (Et,) motion vertex ids
    tern_valid: jnp.ndarray

    Ld_U0: jnp.ndarray             # (Pld, 3, 3) dynamic line vertices
    Ld_w0: jnp.ndarray
    Ld_valid: jnp.ndarray
    dl_cam: jnp.ndarray
    dl_line: jnp.ndarray
    dl_meas: jnp.ndarray           # (Edl, 6)
    dl_valid: jnp.ndarray
    ltern_prev: jnp.ndarray
    ltern_cur: jnp.ndarray
    ltern_mot: jnp.ndarray
    ltern_valid: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BAWeights:
    """sigma^2 per edge type (Optimizer.cc:4008-4018) + Huber deltas."""

    sigma2_cam: float = 0.001
    sigma2_3d_sta: float = 80.0
    sigma2_obj_smo: float = 0.001
    sigma2_obj: float = 100.0
    sigma2_3d_dyn: float = 80.0
    prior_info: float = 1e5
    huber_cam: float = 1e-4
    huber_obj: float = 1e-4
    huber_3d: float = 1e-4
    robust: bool = True
    # EdgeSE3Altitude (types_dyn_slam3d.h:67-83): 1-dof y-translation
    # constraint on motion vertices; the reference defaults it OFF
    # (ALTITUDE_CONSTRAINT=false, Optimizer.cc:4026)
    use_altitude: bool = False
    sigma2_alti: float = 0.1


class BAState(NamedTuple):
    cam_T: jnp.ndarray
    mot_T: jnp.ndarray
    Xs: jnp.ndarray
    Ls_U: jnp.ndarray
    Ls_w: jnp.ndarray
    Xd: jnp.ndarray
    Ld_U: jnp.ndarray
    Ld_w: jnp.ndarray


def _zeros_delta(state: BAState) -> dict:
    return dict(
        cam=jnp.zeros((state.cam_T.shape[0], 6), state.cam_T.dtype),
        mot=jnp.zeros((state.mot_T.shape[0], 6), state.cam_T.dtype),
        xs=jnp.zeros_like(state.Xs),
        ls=jnp.zeros((state.Ls_U.shape[0], 4), state.cam_T.dtype),
        xd=jnp.zeros_like(state.Xd),
        ld=jnp.zeros((state.Ld_U.shape[0], 4), state.cam_T.dtype),
    )


def _retract(state: BAState, d: dict) -> BAState:
    """Apply local deltas: poses/motions right-multiplied exp (g2o VertexSE3
    convention), points added, lines orthonormal-retracted."""
    # se3_orthonormalize: BA iterates 15+ retractions per window; projecting
    # back onto SE(3) each step stops f32 orthonormality drift from leaking
    # into the refined poses (lie.so3_orthonormalize doc)
    cam_T = jax.vmap(
        lambda T, x: lie.se3_orthonormalize(T @ lie.se3_exp(x))
    )(state.cam_T, d["cam"])
    mot_T = jax.vmap(
        lambda T, x: lie.se3_orthonormalize(T @ lie.se3_exp(x))
    )(state.mot_T, d["mot"])
    Ls = jax.vmap(geometry.orthonormal_retract)(state.Ls_U, state.Ls_w, d["ls"])
    Ld = jax.vmap(geometry.orthonormal_retract)(state.Ld_U, state.Ld_w, d["ld"])
    return BAState(
        cam_T=cam_T, mot_T=mot_T,
        Xs=state.Xs + d["xs"], Ls_U=Ls[0], Ls_w=Ls[1],
        Xd=state.Xd + d["xd"], Ld_U=Ld[0], Ld_w=Ld[1],
    )


# ---------------------------------------------------------------------------
# Edge residuals (single edge; vmapped).  Each takes the local deltas of its
# connected vertices so vmap(jacfwd) yields the per-edge Jacobian blocks.
# ---------------------------------------------------------------------------


def _r_se3(d_i, d_j, T_i, T_j, meas):
    """EdgeSE3: r = log(meas^-1 (T_i exp(d_i))^-1 (T_j exp(d_j)))."""
    Ti = T_i @ lie.se3_exp(d_i)
    Tj = T_j @ lie.se3_exp(d_j)
    return lie.se3_log(lie.se3_inv(meas) @ lie.se3_inv(Ti) @ Tj)


def _r_prior(d_i, T_i, meas):
    return lie.se3_log(lie.se3_inv(meas) @ T_i @ lie.se3_exp(d_i))


def _r_point(d_cam, d_pt, T, X, meas):
    """EdgeSE3PointXYZ: r = (T exp(d))^-1 (X + d_pt) - meas."""
    Tc = T @ lie.se3_exp(d_cam)
    return lie.transform_point(lie.se3_inv(Tc), X + d_pt) - meas


def _r_line_obs(d_cam, d_line, T, U, w, meas6):
    """EdgeSE3OrthoLine (edge_se3_ortho_line.cpp:88-137): transform the
    world Pluecker line into the camera and measure both endpoint
    distances."""
    Tc = T @ lie.se3_exp(d_cam)
    U2, w2 = geometry.orthonormal_retract(U, w, d_line)
    L_w = geometry.orthonormal_to_plucker(U2, w2)
    L_c = lie.line_transform_6x6(lie.se3_inv(Tc)) @ L_w
    n, u = L_c[:3], L_c[3:]
    d1 = _safe_norm3(jnp.cross(meas6[:3], u) - n)
    d2 = _safe_norm3(jnp.cross(meas6[3:], u) - n)
    return jnp.stack([d1, d2])


def _safe_norm3(x):
    return jnp.sqrt(jnp.sum(x * x) + 1e-12)


def _r_altitude(d_mot, H):
    """EdgeSE3Altitude (types_dyn_slam3d.cpp:704): y translation of the
    motion vertex, measurement 0."""
    Hm = H @ lie.se3_exp(d_mot)
    return Hm[1:2, 3]


def _r_tern(d_prev, d_cur, d_mot, Xp, Xc, H):
    """LandmarkMotionTernaryEdge (types_dyn_slam3d.cpp:53-60):
    r = x_prev - H^-1 x_cur."""
    Hm = H @ lie.se3_exp(d_mot)
    return (Xp + d_prev) - lie.transform_point(lie.se3_inv(Hm), Xc + d_cur)


def _r_line_tern(d_prev, d_cur, d_mot, Up, wp, Uc, wc, H):
    """LineLandmarkMotionTernaryEdge (types_dyn_slam3d.cpp:226-315):
    r = [line_distance(H L_prev, L_cur), 1-|cos angle|]."""
    Hm = H @ lie.se3_exp(d_mot)
    U1, w1 = geometry.orthonormal_retract(Up, wp, d_prev)
    U2, w2 = geometry.orthonormal_retract(Uc, wc, d_cur)
    L1 = geometry.orthonormal_to_plucker(U1, w1)
    L2 = geometry.orthonormal_to_plucker(U2, w2)
    L1t = lie.line_transform_6x6(Hm) @ L1
    return jnp.stack([
        geometry.plucker_line_distance(L1t, L2),
        geometry.plucker_angle_error(L1t, L2),
    ])


def _huber_w(chi2, delta, robust):
    if not robust:
        return jnp.ones_like(chi2)
    safe = jnp.maximum(chi2, 1e-20)
    return jnp.where(chi2 <= delta * delta, 1.0, delta / jnp.sqrt(safe))


def _huber_rho(chi2, delta, robust):
    if not robust:
        return chi2
    safe = jnp.maximum(chi2, 1e-20)
    return jnp.where(
        chi2 <= delta * delta, chi2, 2 * delta * jnp.sqrt(safe) - delta * delta
    )


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


def _edges(graph: BAGraph, state: BAState, w: BAWeights):
    """Yield (name, residual_fn(deltas...), gathered static args, vertex
    index arrays + which delta family each belongs to, info, huber delta,
    valid)."""
    g, s = graph, state
    return [
        # (fn, [(family, idx)...], const args, info, delta, valid)
        ("odo", _r_se3,
         [("cam", g.odo_i), ("cam", g.odo_j)],
         (s.cam_T[g.odo_i], s.cam_T[g.odo_j], g.odo_meas),
         1.0 / w.sigma2_cam, w.huber_cam, g.odo_valid, 6),
        ("smo", _r_se3,
         [("mot", g.smo_i), ("mot", g.smo_j)],
         (s.mot_T[g.smo_i], s.mot_T[g.smo_j],
          jnp.broadcast_to(jnp.eye(4, dtype=s.cam_T.dtype),
                           (g.smo_i.shape[0], 4, 4))),
         1.0 / w.sigma2_obj_smo, w.huber_cam, g.smo_valid, 6),
        ("sp", _r_point,
         [("cam", g.sp_cam), ("xs", g.sp_pt)],
         (s.cam_T[g.sp_cam], s.Xs[g.sp_pt], g.sp_meas),
         1.0 / w.sigma2_3d_sta, w.huber_3d, g.sp_valid, 3),
        ("sl", _r_line_obs,
         [("cam", g.sl_cam), ("ls", g.sl_line)],
         (s.cam_T[g.sl_cam], s.Ls_U[g.sl_line], s.Ls_w[g.sl_line], g.sl_meas),
         1.0 / w.sigma2_3d_sta, w.huber_3d, g.sl_valid, 2),
        ("dp", _r_point,
         [("cam", g.dp_cam), ("xd", g.dp_pt)],
         (s.cam_T[g.dp_cam], s.Xd[g.dp_pt], g.dp_meas),
         1.0 / w.sigma2_3d_dyn, w.huber_3d, g.dp_valid, 3),
        ("tern", _r_tern,
         [("xd", g.tern_prev), ("xd", g.tern_cur), ("mot", g.tern_mot)],
         (s.Xd[g.tern_prev], s.Xd[g.tern_cur], s.mot_T[g.tern_mot]),
         1.0 / w.sigma2_obj, w.huber_obj, g.tern_valid, 3),
        ("dl", _r_line_obs,
         [("cam", g.dl_cam), ("ld", g.dl_line)],
         (s.cam_T[g.dl_cam], s.Ld_U[g.dl_line], s.Ld_w[g.dl_line], g.dl_meas),
         1.0 / w.sigma2_3d_dyn, w.huber_3d, g.dl_valid, 2),
        ("alt", _r_altitude,
         [("mot", jnp.arange(s.mot_T.shape[0], dtype=jnp.int32))],
         (s.mot_T,),
         1.0 / w.sigma2_alti, w.huber_obj,
         g.mot_valid & bool(w.use_altitude), 1),
        ("ltern", _r_line_tern,
         [("ld", g.ltern_prev), ("ld", g.ltern_cur), ("mot", g.ltern_mot)],
         (s.Ld_U[g.ltern_prev], s.Ld_w[g.ltern_prev],
          s.Ld_U[g.ltern_cur], s.Ld_w[g.ltern_cur],
          s.mot_T[g.ltern_mot]),
         1.0 / w.sigma2_obj, w.huber_obj, g.ltern_valid, 2),
    ]


_FAMILY_DIM = {"cam": 6, "mot": 6, "xs": 3, "ls": 4, "xd": 3, "ld": 4}


def _linearize(graph: BAGraph, state: BAState, w: BAWeights):
    """Residuals + per-edge jacobians + frozen robust*info weights."""
    out = []
    for name, fn, verts, consts, info, delta, valid, rdim in _edges(
        graph, state, w
    ):
        n_v = len(verts)
        E = verts[0][1].shape[0]
        zeros = [jnp.zeros((E, _FAMILY_DIM[fam]), state.cam_T.dtype)
                 for fam, _ in verts]
        r = jax.vmap(fn)(*zeros, *consts)                    # (E, rdim)
        jacs = jax.vmap(jax.jacfwd(fn, argnums=tuple(range(n_v))))(
            *zeros, *consts
        )                                                    # tuple (E, rdim, d)
        r = jnp.nan_to_num(jnp.where(valid[:, None], r, 0.0))
        jacs = tuple(
            jnp.nan_to_num(jnp.where(valid[:, None, None], J, 0.0))
            for J in jacs
        )
        chi2 = info * jnp.sum(r * r, axis=-1)
        wgt = valid * _huber_w(chi2, delta, w.robust) * info  # (E,)
        rho = jnp.sum(valid * _huber_rho(chi2, delta, w.robust))
        out.append(dict(name=name, verts=verts, r=r, jacs=jacs, wgt=wgt,
                        rho=rho))
    # prior edge (single)
    d0 = jnp.zeros(6, state.cam_T.dtype)
    T0 = state.cam_T[graph.prior_frame]
    r_p = _r_prior(d0, T0, graph.prior_meas)
    J_p = jax.jacfwd(_r_prior)(d0, T0, graph.prior_meas)
    cost = sum(o["rho"] for o in out) + graph.prior_info * jnp.sum(r_p * r_p)
    return out, (r_p, J_p), cost


def _cost_only(graph, state, w):
    total = 0.0
    for name, fn, verts, consts, info, delta, valid, rdim in _edges(
        graph, state, w
    ):
        E = verts[0][1].shape[0]
        zeros = [jnp.zeros((E, _FAMILY_DIM[fam]), state.cam_T.dtype)
                 for fam, _ in verts]
        r = jnp.nan_to_num(jax.vmap(fn)(*zeros, *consts))
        chi2 = info * jnp.sum(r * r, axis=-1)
        total = total + jnp.sum(valid * _huber_rho(chi2, delta, w.robust))
    d0 = jnp.zeros(6, state.cam_T.dtype)
    r_p = _r_prior(d0, state.cam_T[graph.prior_frame], graph.prior_meas)
    return total + graph.prior_info * jnp.sum(r_p * r_p)


def _hvp_and_grad(lin, prior, graph, template):
    """Return (grad dict, hvp function, block-diag dict) from linearized
    edges.  All pure einsum/gather/scatter -- shards over the edge axis."""
    r_p, J_p = prior

    def grad():
        g = {k: jnp.zeros_like(v) for k, v in template.items()}
        for o in lin:
            for (fam, idx), J in zip(o["verts"], o["jacs"]):
                contrib = jnp.einsum(
                    "eri,er,e->ei", J, o["r"], o["wgt"], precision=_HI
                )
                g[fam] = g[fam].at[idx].add(contrib)
        g["cam"] = g["cam"].at[graph.prior_frame].add(
            graph.prior_info * (J_p.T @ r_p)
        )
        return g

    def hvp(v):
        out = {k: jnp.zeros_like(x) for k, x in template.items()}
        for o in lin:
            # y_e = sum_k J_k v_k
            y = None
            for (fam, idx), J in zip(o["verts"], o["jacs"]):
                t = jnp.einsum("eri,ei->er", J, v[fam][idx], precision=_HI)
                y = t if y is None else y + t
            y = y * o["wgt"][:, None]
            for (fam, idx), J in zip(o["verts"], o["jacs"]):
                out[fam] = out[fam].at[idx].add(
                    jnp.einsum("eri,er->ei", J, y, precision=_HI)
                )
        out["cam"] = out["cam"].at[graph.prior_frame].add(
            graph.prior_info * (J_p.T @ (J_p @ v["cam"][graph.prior_frame]))
        )
        return out

    def block_diag():
        bd = {
            k: jnp.zeros(v.shape + (v.shape[-1],), v.dtype)
            for k, v in template.items()
        }
        for o in lin:
            for (fam, idx), J in zip(o["verts"], o["jacs"]):
                blk = jnp.einsum("eri,erj,e->eij", J, J, o["wgt"],
                                 precision=_HI)
                bd[fam] = bd[fam].at[idx].add(blk)
        bd["cam"] = bd["cam"].at[graph.prior_frame].add(
            graph.prior_info * (J_p.T @ J_p)
        )
        return bd

    return grad(), hvp, block_diag()


def _inv2(A):
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    return jnp.stack([
        jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)
    ], -2) / det[..., None, None]


def _inv_spd_small(A):
    """Batched closed-form inverse for the damped SPD preconditioner
    blocks.  ``jnp.linalg.inv`` runs tens of thousands of tiny batched
    LU factorizations at window scale (the ~25k 3x3/4x4 point/line
    blocks); the adjugate (3x3) and block-2x2 Schur (4x4) forms are pure
    elementwise math that fuses.  Blocks are damped SPD (H_ii + lam + 1e-8), so every
    sub-inverse is well-conditioned.  6x6 pose blocks (~100 of them)
    keep linalg.inv."""
    n = A.shape[-1]
    if n == 2:
        return _inv2(A)
    if n == 3:
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        c11 = e * i - f * h
        c12 = c * h - b * i
        c13 = b * f - c * e
        c21 = f * g - d * i
        c22 = a * i - c * g
        c23 = c * d - a * f
        c31 = d * h - e * g
        c32 = b * g - a * h
        c33 = a * e - b * d
        det = a * c11 + b * c21 + c * c31
        adj = jnp.stack([
            jnp.stack([c11, c12, c13], -1),
            jnp.stack([c21, c22, c23], -1),
            jnp.stack([c31, c32, c33], -1),
        ], -2)
        return adj / det[..., None, None]
    if n == 4:
        mm = functools.partial(jnp.matmul, precision=_HI)
        A_, B_ = A[..., :2, :2], A[..., :2, 2:]
        C_, D_ = A[..., 2:, :2], A[..., 2:, 2:]
        Ai = _inv2(A_)
        Si = _inv2(D_ - mm(C_, mm(Ai, B_)))
        AiB = mm(Ai, B_)
        CAi = mm(C_, Ai)
        top = jnp.concatenate(
            [Ai + mm(AiB, mm(Si, CAi)), -mm(AiB, Si)], -1
        )
        bot = jnp.concatenate([-mm(Si, CAi), Si], -1)
        return jnp.concatenate([top, bot], -2)
    return jnp.linalg.inv(A)


def _tree_dot(a, b, dtype=None):
    """Tree inner product; ``dtype`` upcasts the reduction (the
    mixed-precision CG accumulates its recurrences in f64 while storage
    and the HVP stay f32 — see ``ba_dtype: "mixed"`` in utils/config)."""
    if dtype is None:
        return sum(jnp.vdot(a[k], b[k]) for k in a)
    return sum(
        jnp.vdot(a[k].astype(dtype), b[k].astype(dtype)) for k in a
    )


# ---------------------------------------------------------------------------
# Split compilation units: the monolithic step's dominant compile cost is
# the vmapped jacfwd chains, paid again for every shape bucket.  run_ba
# therefore
# linearizes each edge type in its own small jit and solves the normal
# equations in a jacobian-consuming CG jit -- each unit compiles in
# seconds and is shared between the partial and full BA when buckets match.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("w", "idx"))
def _linearize_edge(graph: BAGraph, state: BAState, w: BAWeights, idx: int):
    """Linearize edge type ``idx`` of the _edges list."""
    name, fn, verts, consts, info, delta, valid, rdim = _edges(
        graph, state, w
    )[idx]
    n_v = len(verts)
    E = verts[0][1].shape[0]
    zeros = [jnp.zeros((E, _FAMILY_DIM[fam]), state.cam_T.dtype)
             for fam, _ in verts]
    r = jax.vmap(fn)(*zeros, *consts)
    jacs = jax.vmap(jax.jacfwd(fn, argnums=tuple(range(n_v))))(
        *zeros, *consts
    )
    r = jnp.nan_to_num(jnp.where(valid[:, None], r, 0.0))
    jacs = tuple(
        jnp.nan_to_num(jnp.where(valid[:, None, None], J, 0.0))
        for J in jacs
    )
    chi2 = info * jnp.sum(r * r, axis=-1)
    wgt = valid * _huber_w(chi2, delta, w.robust) * info
    rho = jnp.sum(valid * _huber_rho(chi2, delta, w.robust))
    return r, jacs, wgt, rho


@functools.partial(
    jax.jit, static_argnames=("w", "reduce_dtype")
)
def _solve_normal_eq(graph: BAGraph, state: BAState, w: BAWeights,
                     lin_flat, prior, lam, cg_iters: int,
                     reduce_dtype=None, cg_rtol=1e-4):
    """CG on precomputed per-edge jacobians (no jacfwd in this program)."""
    template = _zeros_delta(state)
    # rebuild the lin dicts with vertex indices from the graph
    specs = _edges(graph, state, w)
    lin = []
    for (name, _, verts, _, _, _, _, _), (r, jacs, wgt, _) in zip(
        specs, lin_flat
    ):
        lin.append(dict(name=name, verts=verts, r=r, jacs=jacs, wgt=wgt))
    g, hvp, bd = _hvp_and_grad(lin, prior, graph, template)
    eye = {
        k: jnp.broadcast_to(jnp.eye(v.shape[-1], dtype=v.dtype), v.shape)
        for k, v in bd.items()
    }
    bd_damped = {k: bd[k] + lam * eye[k] for k in bd}
    pinv = {k: _inv_spd_small(bd_damped[k] + 1e-8 * eye[k]) for k in bd}
    return _pcg(hvp, g, pinv, lam, cg_iters, state.cam_T.dtype,
                reduce_dtype, cg_rtol)


def _pcg(hvp, g, pinv, lam, cg_iters, dt, reduce_dtype=None,
         cg_rtol=1e-4):
    """Block-Jacobi preconditioned CG on the damped normal equations.

    With ``reduce_dtype`` set (``ba_dtype: "mixed"``), the CG recurrence
    vectors (x, r, p, z) and every inner product run in that dtype while
    the Hessian-vector product and the preconditioner apply stay in the
    storage dtype ``dt`` (f32): the matvec's rounding is a
    per-iteration perturbation CG tolerates, but rounding the
    *accumulated* recurrences compounds across iterations and is what
    stalls f32 CG on ill-conditioned multi-hundred-frame graphs.
    Tracing f64 requires jax x64 enabled (ba_builder._x64_scope).
    """
    rd = dt if reduce_dtype is None else reduce_dtype
    if jnp.zeros((), rd).dtype != jnp.dtype(rd):
        # without x64 the f64 casts silently no-op to f32 and the mode
        # would claim precision it doesn't deliver — fail at trace time
        raise ValueError(
            "reduce_dtype %s unavailable: enable jax x64 around the "
            "solve (ba_builder._x64_scope)" % rd
        )
    lam_r = lam.astype(rd)

    def A(v):
        hv = hvp({k: v[k].astype(dt) for k in v})
        return {k: hv[k].astype(rd) + lam_r * v[k] for k in hv}

    def M(v):
        return {
            k: jnp.einsum(
                "nij,nj->ni", pinv[k], v[k].astype(dt), precision=_HI
            ).astype(rd)
            for k in v
        }

    b = {k: (-g[k]).astype(rd) for k in g}
    x = {k: jnp.zeros_like(v) for k, v in b.items()}
    r = b
    z = M(r)
    p = z
    rz = _tree_dot(r, z)
    rz0 = rz

    def cond(carry):
        # inexact-Newton exit: the LM step only needs the system solved
        # to ~1e-2 residual (rz ~ ||r||_M^2); converged windows stop in
        # a handful of iterations instead of burning the full budget.
        # cg_rtol tightens this for callers that need the UNIQUE damped
        # solution (parity tests): at the default tolerance two
        # correct implementations may return different equally-good
        # deltas along weakly-determined directions.
        x, r, z, p, rz, i = carry
        return (i < cg_iters) & (rz > cg_rtol * rz0)

    def body(carry):
        x, r, z, p, rz, i = carry
        Ap = A(p)
        alpha = rz / jnp.maximum(_tree_dot(p, Ap), 1e-20)
        x = {k: x[k] + alpha * p[k] for k in x}
        r = {k: r[k] - alpha * Ap[k] for k in r}
        z = M(r)
        rz_new = _tree_dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = {k: z[k] + beta * p[k] for k in p}
        return x, r, z, p, rz_new, i + 1

    x, r, z, p, rz, _ = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.asarray(0, jnp.int32))
    )
    gain_den = _tree_dot(
        x, {k: lam_r * x[k] - g[k].astype(rd) for k in x}
    )
    return {k: x[k].astype(dt) for k in x}, gain_den.astype(dt)


@functools.partial(jax.jit, static_argnames=())
def _prior_lin(state: BAState, prior_frame, prior_meas):
    d0 = jnp.zeros(6, state.cam_T.dtype)
    T0 = state.cam_T[prior_frame]
    r_p = _r_prior(d0, T0, prior_meas)
    J_p = jax.jacfwd(_r_prior)(d0, T0, prior_meas)
    return r_p, J_p


def ba_gn_step_split(graph: BAGraph, state: BAState, w: BAWeights,
                     lam, cg_iters: int = 40, n_types: int = 9,
                     reduce_dtype=None, cg_rtol=1e-4):
    """The damped-GN step assembled from the small compilation units."""
    lin_flat = tuple(
        _linearize_edge(graph, state, w, i) for i in range(n_types)
    )
    cost = sum(o[3] for o in lin_flat)
    prior = _prior_lin(state, graph.prior_frame, graph.prior_meas)
    cost = cost + graph.prior_info * jnp.sum(prior[0] * prior[0])
    d, gain_den = _solve_normal_eq(
        graph, state, w, lin_flat, prior, lam, cg_iters,
        reduce_dtype=reduce_dtype, cg_rtol=cg_rtol,
    )
    return d, cost, gain_den


def ba_gn_step(graph: BAGraph, state: BAState, w: BAWeights,
               lam: jnp.ndarray, cg_iters: int = 40, reduce_dtype=None,
               cg_rtol=1e-4):
    """One damped GN step: linearize, solve (H + lam*blockdiag(H)) d = -g
    with block-Jacobi preconditioned CG, return (delta, cost, gain_den)."""
    template = _zeros_delta(state)
    lin, prior, cost = _linearize(graph, state, w)
    g, hvp, bd = _hvp_and_grad(lin, prior, graph, template)

    eye = {
        k: jnp.broadcast_to(
            jnp.eye(v.shape[-1], dtype=v.dtype), v.shape
        )
        for k, v in bd.items()
    }
    # LM damping on the block diagonal (g2o: H_ii += lam)
    bd_damped = {k: bd[k] + lam * eye[k] for k in bd}
    pinv = {k: _inv_spd_small(bd_damped[k] + 1e-8 * eye[k]) for k in bd}
    x, gain_den = _pcg(hvp, g, pinv, lam, cg_iters, state.cam_T.dtype,
                       reduce_dtype, cg_rtol)
    return x, cost, gain_den


@functools.partial(
    jax.jit,
    # the solver BUDGETS (max_iters / cg_iters / gain_threshold) are
    # TRACED scalars, not static args: both loops are lax.while_loops
    # whose conds read them as operands, so one compiled program serves
    # every budget — a budget sweep (examples/tune_lba.py) or a config
    # change never pays the fused-program compile again
    static_argnames=("w", "reduce_dtype"),
)
def run_ba_fused(graph: BAGraph, w: BAWeights, max_iters: int = 20,
                 cg_iters: int = 40, gain_threshold: float = 1e-4,
                 reduce_dtype=None):
    """The WHOLE LM outer loop as ONE device program.

    The split-unit path (``run_ba``) costs ~13 dispatches per LM
    iteration, each with its fixed launch and sync latency.  Here the LM
    loop (linearize -> CG ->
    retract -> accept/reject with damping adaptation, the same logic as
    the reference's g2o OptimizationAlgorithmLevenberg +
    SparseOptimizerTerminateAction gain test, Optimizer.cc:4004) runs
    under ``lax.while_loop``: one dispatch per BA call regardless of
    iteration count.  Compile cost is paid once per shape bucket.

    Returns (final BAState, final cost, iterations executed)."""
    dt = graph.cam_T0.dtype
    state0 = BAState(
        cam_T=graph.cam_T0, mot_T=graph.mot_T0,
        Xs=graph.Xs0, Ls_U=graph.Ls_U0, Ls_w=graph.Ls_w0,
        Xd=graph.Xd0, Ld_U=graph.Ld_U0, Ld_w=graph.Ld_w0,
    )
    cost0 = _cost_only(graph, state0, w)

    def cond(c):
        _, _, _, _, it, done = c
        return (it < max_iters) & ~done

    def body(c):
        state, lam, nu, cost, it, done = c
        x, _, gain_den = ba_gn_step(graph, state, w, lam,
                                    cg_iters=cg_iters,
                                    reduce_dtype=reduce_dtype)
        new_state = _retract(state, x)
        new_cost = _cost_only(graph, new_state, w)
        rho = (cost - new_cost) / jnp.maximum(gain_den, 1e-20)
        ok = jnp.isfinite(new_cost) & (rho > 0)
        gain = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok, b, a), state, new_state
        )
        cost = jnp.where(ok, new_cost, cost)
        lam = jnp.where(
            ok,
            lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            lam * nu,
        )
        nu = jnp.where(ok, 2.0, nu * 2.0)
        done = done | (ok & (gain < gain_threshold)) | (lam > 1e12)
        return state, lam, nu, cost, it + 1, done

    carry = (
        state0, jnp.asarray(1e-5, dt), jnp.asarray(2.0, dt), cost0,
        jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    state, lam, nu, cost, it, done = jax.lax.while_loop(cond, body, carry)
    return state, cost, it


def run_ba(graph: BAGraph, w: BAWeights, max_iters: int = 20,
           cg_iters: int = 40, gain_threshold: float = 1e-4,
           verbose: bool = False, reduce_dtype=None):
    """LM outer loop (python; each step one jitted device program).
    Terminates on the reference's relative-gain criterion
    (SparseOptimizerTerminateAction, gain < 1e-4, Optimizer.cc:4004)."""
    state = BAState(
        cam_T=graph.cam_T0, mot_T=graph.mot_T0,
        Xs=graph.Xs0, Ls_U=graph.Ls_U0, Ls_w=graph.Ls_w0,
        Xd=graph.Xd0, Ld_U=graph.Ld_U0, Ld_w=graph.Ld_w0,
    )
    cost_fn = jax.jit(_cost_only, static_argnames=("w",))
    retract = jax.jit(_retract)

    lam = jnp.asarray(1e-5, graph.cam_T0.dtype)
    nu = 2.0
    cost = float(cost_fn(graph, state, w))
    for it in range(max_iters):
        d, _, gain_den = ba_gn_step_split(
            graph, state, w, lam, cg_iters=cg_iters,
            reduce_dtype=reduce_dtype,
        )
        new_state = retract(state, d)
        new_cost = float(cost_fn(graph, new_state, w))
        rho = (cost - new_cost) / max(float(gain_den), 1e-20)
        if np.isfinite(new_cost) and rho > 0:
            gain = (cost - new_cost) / max(cost, 1e-20)
            state = new_state
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            if verbose:
                print(f"BA it {it}: cost {cost:.6g} -> {new_cost:.6g}")
            cost = new_cost
            if gain < gain_threshold:
                break
        else:
            lam = lam * nu
            nu = nu * 2.0
            if float(lam) > 1e12:
                break
    return state, cost
