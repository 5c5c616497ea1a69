"""Dense-Schur direct solver for window-scale batch BA.

The g2o back-end eliminates landmark vertices with a Schur complement
before solving the reduced (pose+motion) system
(``BlockSolver::solve``, dependencies/g2o/g2o/core/block_solver.hpp —
every landmark vertex is ``setMarginalized(true)`` in the reference's
batch optimizers, /root/reference/src/Optimizer.cc:4124,4233,4785).
The matrix-free CG path in :mod:`.batch_ba` instead iterates Hessian-
vector products over all edges (~40 edge streams per LM iteration).

For WINDOW-scale graphs the reduced system is tiny — 6*(frames +
motions) ≈ 350 dof for the reference's 20-frame window — so the exact
g2o strategy trades the CG loop for dense linear algebra:

 * static points / lines have block-diagonal Hessian blocks (3x3 / 4x4)
   — closed-form batched inverses;
 * dynamic points / lines are chained by ternary motion edges
   (LandmarkMotionTernaryEdge: one vertex PER OBSERVATION linked to its
   predecessor, Optimizer.cc:4763-4813) — their Hessian is
   block-TRIDIAGONAL along each tracklet chain; chains factor with a
   batched block-Thomas scan (vmap over chains, lax.scan over length);
 * the coupling blocks ``B`` are materialized densely per landmark
   family ((P, d, NDOF) — ~150 MB at KITTI window caps) so the Schur
   complement  S = A - Bᵀ D⁻¹ B  is ONE big matmul, and the damped
   step solves by dense Cholesky.

Per LM iteration: one linearization + scatter assembly + two matmuls +
a (NDOF,NDOF) Cholesky — no CG loop.  ``run_ba_fused_schur`` wraps the
LM loop in ``lax.while_loop`` like ``batch_ba.run_ba_fused``.

Falls back to the CG path above ``MAX_DENSE_DOF`` (full-sequence BA)
— there the edge-sharded CG remains the multi-chip scale path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import batch_ba as bb

_HI = jax.lax.Precision.HIGHEST

MAX_DENSE_DOF = 2048


class SchurMeta(NamedTuple):
    """Chain structure of the dynamic landmark families.

    ``xd_chain``: (NC, K) int32 vertex ids forming each block-tridiagonal
    chain (consecutive ids by construction of build_graph), -1 padded.
    ``ld_chain``: same for dynamic line vertices."""

    xd_chain: jnp.ndarray
    ld_chain: jnp.ndarray
    n_frames: int
    n_motions: int


def chains_from_links(n_verts: int, link_prev: np.ndarray, k_max: int,
                      valid: np.ndarray | None = None):
    """Maximal runs of consecutive vertex ids connected by ternary
    links (link at i means blocks (i, i+1) are coupled).  Returns an
    (NC, k_max) int32 matrix, -1 padded.

    ``valid`` masks out padding entries of ``link_prev`` (the graph's
    ``tern_valid``); without it a pad zero would create a spurious 0->1
    link.  Real runs are per-tracklet consecutive vertices — one vertex
    per window frame — so a run can never exceed ``k_max`` = F; that is
    asserted, because silently splitting a longer run would drop its
    coupling block and make the "exact direct step" claim false."""
    n = max(int(n_verts), 0)
    if n == 0:
        return np.full((1, k_max), -1, np.int32)
    has_link = np.zeros(n, bool)
    lp = np.asarray(link_prev, np.int64)
    if valid is not None:
        lp = lp[np.asarray(valid, bool)[: len(lp)]]
    lp = lp[(lp >= 0) & (lp < n - 1)]
    has_link[lp] = True
    starts = np.nonzero(
        np.concatenate([[True], ~has_link[:-1]])
    )[0]
    ends = np.concatenate([starts[1:], [n]])
    run_max = int((ends - starts).max())
    if valid is not None and run_max > k_max:
        raise AssertionError(
            f"ternary chain of length {run_max} exceeds window size "
            f"{k_max}; graph construction invariant violated"
        )
    rows = []
    for s, e in zip(starts, ends):
        i = s
        while i < e:
            ln = min(e - i, k_max)
            row = np.full(k_max, -1, np.int32)
            row[:ln] = np.arange(i, i + ln, dtype=np.int32)
            rows.append(row)
            i += ln
    return np.stack(rows).astype(np.int32)


# ---------------------------------------------------------------------------
# batched block-tridiagonal factor/solve (block-Thomas over chains)
# ---------------------------------------------------------------------------


def _tridiag_solve(chain, Dd, Eo, rhs):
    """Solve the block-tridiagonal system along every chain.

    chain: (NC, K) vertex ids (-1 pad); Dd: (P, d, d) diagonal blocks;
    Eo: (P, d, d) super-diagonal blocks (Eo[i] couples i and i+1; only
    meaningful inside chains); rhs: (P, d, W).  Returns (P, d, W) with
    chain-covered rows solved exactly; uncovered (padding) rows solved
    block-diagonally."""
    P, d, W = rhs.shape
    NC, K = chain.shape
    idx = jnp.clip(chain, 0, P - 1)
    ok = chain >= 0                                  # (NC, K)
    okf = ok.astype(Dd.dtype)
    eye = jnp.eye(d, dtype=Dd.dtype)
    Dc = jnp.where(ok[..., None, None], Dd[idx], eye)      # (NC, K, d, d)
    rc = jnp.where(ok[..., None, None], rhs[idx], 0.0)     # (NC, K, d, W)
    # E between position i and i+1 exists when both are real
    link = ok[:, :-1] & ok[:, 1:]
    Ec = jnp.where(
        link[..., None, None], Eo[jnp.clip(chain[:, :-1], 0, P - 1)], 0.0
    )                                                      # (NC, K-1, d, d)
    Ec = jnp.concatenate(
        [Ec, jnp.zeros((NC, 1, d, d), Dd.dtype)], axis=1
    )                                                      # (NC, K, d, d)

    # forward elimination:  Dh_0 = D_0, z_0 = r_0
    #   Dh_i = D_i - E_{i-1}^T Dh_{i-1}^{-1} E_{i-1}
    #   z_i  = r_i - E_{i-1}^T Dh_{i-1}^{-1} z_{i-1}
    def fwd(carry, inp):
        Dh_prev_inv, z_prev = carry
        D_i, E_prev, r_i = inp
        M = jnp.einsum("cab,cad->cbd", E_prev, Dh_prev_inv,
                       precision=_HI)                      # E^T Dh^{-1}
        Dh = D_i - jnp.einsum("cab,cbd->cad", M, E_prev, precision=_HI)
        z = r_i - jnp.einsum("cab,cbw->caw", M, z_prev, precision=_HI)
        Dh_inv = jnp.linalg.inv(
            Dh + 1e-10 * jnp.eye(d, dtype=Dh.dtype)
        )
        return (Dh_inv, z), (Dh_inv, z)

    D0_inv = jnp.linalg.inv(
        Dc[:, 0] + 1e-10 * jnp.eye(d, dtype=Dc.dtype)
    )
    z0 = rc[:, 0]
    xs = (
        jnp.swapaxes(Dc[:, 1:], 0, 1),
        jnp.swapaxes(Ec[:, :-1], 0, 1),
        jnp.swapaxes(rc[:, 1:], 0, 1),
    )
    (_, _), (Dh_inv_rest, z_rest) = jax.lax.scan(fwd, (D0_inv, z0), xs)
    Dh_inv = jnp.concatenate(
        [D0_inv[None], Dh_inv_rest], axis=0
    )                                                      # (K, NC, d, d)
    zs = jnp.concatenate([z0[None], z_rest], axis=0)       # (K, NC, d, W)

    # back substitution: y_K = Dh_K^{-1} z_K;
    #   y_i = Dh_i^{-1} (z_i - E_i y_{i+1})
    E_t = jnp.swapaxes(Ec, 0, 1)                           # (K, NC, d, d)

    def bwd(y_next, inp):
        Dh_inv_i, z_i, E_i = inp
        y = jnp.einsum(
            "cab,cbw->caw", Dh_inv_i,
            z_i - jnp.einsum("cab,cbw->caw", E_i, y_next, precision=_HI),
            precision=_HI,
        )
        return y, y

    yK = jnp.einsum("cab,cbw->caw", Dh_inv[-1], zs[-1], precision=_HI)
    _, ys_rev = jax.lax.scan(
        bwd, yK,
        (Dh_inv[:-1][::-1], zs[:-1][::-1], E_t[:-1][::-1]),
    )
    ys = jnp.concatenate([ys_rev[::-1], yK[None]], axis=0)  # (K, NC, d, W)
    ys = jnp.swapaxes(ys, 0, 1)                             # (NC, K, d, W)

    out = jnp.zeros_like(rhs)
    out = out.at[idx.reshape(-1)].add(
        (ys * okf[..., None, None]).reshape(-1, d, W)
    )
    covered = jnp.zeros(P, bool).at[idx.reshape(-1)].max(ok.reshape(-1))
    diag_sol = jnp.linalg.solve(
        Dd + 1e-10 * jnp.eye(d, dtype=Dd.dtype), rhs
    )
    return jnp.where(covered[:, None, None], out, diag_sol)


# ---------------------------------------------------------------------------
# dense assembly
# ---------------------------------------------------------------------------

_LMK = {"xs": 3, "ls": 4, "xd": 3, "ld": 4}


def _scatter_A(A, rows_base, cols_base, blocks):
    """A[rows_base+ (0..r), cols_base + (0..c)] += blocks  for a batch of
    edges.  blocks: (E, r, c); bases: (E,)."""
    E, r, c = blocks.shape
    ri = rows_base[:, None, None] + jnp.arange(r)[None, :, None]
    ci = cols_base[:, None, None] + jnp.arange(c)[None, None, :]
    return A.at[ri, ci].add(blocks)


def _scatter_Bt(Bt, vidx, cols_base, blocks):
    """Bt[vidx, :, cols_base + (0..c)] += blocks.  Bt: (P, d, NDOF);
    blocks: (E, d, c)."""
    E, d, c = blocks.shape
    ci = cols_base[:, None, None] + jnp.arange(c)[None, None, :]
    return Bt.at[vidx[:, None, None],
                 jnp.arange(d)[None, :, None], ci].add(blocks)


def dense_schur_step(graph: bb.BAGraph, state: bb.BAState, w: bb.BAWeights,
                     lam, meta: SchurMeta):
    """One damped-GN step solved exactly: assemble the reduced
    (cam+mot) system by Schur elimination of every landmark family and
    solve by dense Cholesky.  Returns (delta dict, cost, gain_den) --
    same contract as batch_ba.ba_gn_step."""
    F, M = meta.n_frames, meta.n_motions
    NDOF = 6 * (F + M)
    dt = state.cam_T.dtype
    lin, (r_p, J_p), cost = bb._linearize(graph, state, w)
    by_name = {o["name"]: o for o in lin}

    A = jnp.zeros((NDOF, NDOF), dt)
    b = jnp.zeros((NDOF,), dt)
    P_sz = {
        "xs": state.Xs.shape[0], "ls": state.Ls_U.shape[0],
        "xd": state.Xd.shape[0], "ld": state.Ld_U.shape[0],
    }
    Bt = {
        f: jnp.zeros((P_sz[f], d, NDOF), dt) for f, d in _LMK.items()
    }
    Dd = {
        f: (lam * jnp.eye(d, dtype=dt))[None].repeat(P_sz[f], 0)
        for f, d in _LMK.items()
    }
    bL = {f: jnp.zeros((P_sz[f], d), dt) for f, d in _LMK.items()}
    Eo = {
        "xd": jnp.zeros((P_sz["xd"], 3, 3), dt),
        "ld": jnp.zeros((P_sz["ld"], 4, 4), dt),
    }

    def cm_base(fam_name, idx):
        return 6 * idx if fam_name == "cam" else 6 * F + 6 * idx

    for o in lin:
        verts = o["verts"]
        jacs = o["jacs"]
        wgt = o["wgt"]
        r = o["r"]
        # per-slot weighted jacobians
        for si, ((fam_i, idx_i), J_i) in enumerate(zip(verts, jacs)):
            JiW = J_i * wgt[:, None, None]
            g_i = jnp.einsum("eri,er->ei", JiW, r, precision=_HI)
            if fam_i in ("cam", "mot"):
                base_i = cm_base(fam_i, idx_i)
                b = b.at[base_i[:, None]
                         + jnp.arange(g_i.shape[1])[None, :]].add(-g_i)
            else:
                bL[fam_i] = bL[fam_i].at[idx_i].add(-g_i)
            for sj, ((fam_j, idx_j), J_j) in enumerate(zip(verts, jacs)):
                blk = jnp.einsum("eri,erj->eij", JiW, J_j, precision=_HI)
                if fam_i in ("cam", "mot") and fam_j in ("cam", "mot"):
                    A = _scatter_A(
                        A,
                        cm_base(fam_i, idx_i),
                        cm_base(fam_j, idx_j),
                        blk,
                    )
                elif fam_i not in ("cam", "mot") and fam_j in ("cam", "mot"):
                    Bt[fam_i] = _scatter_Bt(
                        Bt[fam_i], idx_i,
                        cm_base(fam_j, idx_j), blk,
                    )
                elif fam_i not in ("cam", "mot") and fam_j not in ("cam", "mot"):
                    if si == sj:
                        Dd[fam_i] = Dd[fam_i].at[idx_i].add(blk)
                    elif si < sj:
                        # ternary off-diagonal: (prev, cur) consecutive
                        # ids -- store at prev (cur == prev + 1 by
                        # build_graph construction)
                        okc = (idx_j == idx_i + 1)
                        Eo[fam_i] = Eo[fam_i].at[idx_i].add(
                            jnp.where(okc[:, None, None], blk, 0.0)
                        )
                # cm-landmark (fam_i cm, fam_j landmark) handled by the
                # symmetric (fam_j, fam_i) visit above

    # prior on the anchored camera
    JpW = graph.prior_info * J_p
    A = A.at[
        6 * graph.prior_frame + jnp.arange(6)[:, None],
        6 * graph.prior_frame + jnp.arange(6)[None, :],
    ].add(JpW.T @ J_p)
    b = b.at[6 * graph.prior_frame + jnp.arange(6)].add(-(JpW.T @ r_p))
    cost = cost  # _linearize already includes the prior in cost

    A = A + lam * jnp.eye(NDOF, dtype=dt)

    # Schur: S = A - sum_f Bt_f^T D_f^{-1} Bt_f ; rhs = b - Bt^T D^{-1} bL
    S = A
    rhs = b
    Ysol = {}
    for f, d in _LMK.items():
        aug = jnp.concatenate([Bt[f], bL[f][:, :, None]], axis=2)
        if f in ("xd", "ld"):
            chain = meta.xd_chain if f == "xd" else meta.ld_chain
            sol = _tridiag_solve(chain, Dd[f], Eo[f], aug)
        else:
            sol = jnp.linalg.solve(
                Dd[f] + 1e-10 * jnp.eye(d, dtype=dt), aug
            )
        Ysol[f] = sol
        S = S - jnp.einsum("pdn,pdm->nm", Bt[f], sol[:, :, :NDOF],
                           precision=_HI)
        rhs = rhs - jnp.einsum("pdn,pd->n", Bt[f], sol[:, :, NDOF],
                               precision=_HI)

    # Cholesky is the fast path, but with a large-info prior (1e5/1e7)
    # f32 cancellation in the elimination can leave S slightly
    # indefinite -> NaN factor -> a NaN step that burns an LM iteration
    # as a rejection.  Guard: symmetrize, factor, and fall back to a
    # general LU solve when the factor is NaN.
    S_d = 0.5 * (S + S.T) + 1e-8 * jnp.eye(NDOF, dtype=dt)
    L = jnp.linalg.cholesky(S_d)
    d_chol = jax.scipy.linalg.cho_solve((L, True), rhs)
    d_cm = jax.lax.cond(
        jnp.all(jnp.isfinite(d_chol)),
        lambda: d_chol,
        lambda: jnp.linalg.solve(S_d, rhs),
    )

    # landmark back-substitution: d_L = D^{-1}(bL - Bt d_cm)
    delta = {
        "cam": d_cm[: 6 * F].reshape(F, 6),
        "mot": d_cm[6 * F:].reshape(M, 6),
    }
    for f, d in _LMK.items():
        # D^{-1} bL is the last aug column of sol; subtract D^{-1} Bt d_cm
        corr = jnp.einsum(
            "pdn,n->pd", Ysol[f][:, :, :NDOF], d_cm, precision=_HI
        )
        delta[f] = Ysol[f][:, :, NDOF] - corr

    g_full = {
        "cam": -b[: 6 * F].reshape(F, 6), "mot": -b[6 * F:].reshape(M, 6),
        "xs": -bL["xs"], "ls": -bL["ls"], "xd": -bL["xd"], "ld": -bL["ld"],
    }
    gain_den = sum(
        jnp.vdot(delta[k], lam * delta[k] - g_full[k]) for k in delta
    )
    return delta, cost, gain_den


@functools.partial(
    jax.jit,
    # budgets are traced scalars (one program per shape set, every
    # budget) — see batch_ba.run_ba_fused
    static_argnames=("w", "F", "M"),
)
def run_ba_fused_schur(graph: bb.BAGraph, w: bb.BAWeights,
                       xd_chain, ld_chain, F: int, M: int,
                       max_iters: int = 20,
                       gain_threshold: float = 1e-4):
    """LM loop with the dense-Schur exact step, fused into one device
    program (same damping/gain control as batch_ba.run_ba_fused)."""
    meta = SchurMeta(xd_chain=xd_chain, ld_chain=ld_chain,
                     n_frames=F, n_motions=M)
    dt = graph.cam_T0.dtype
    state0 = bb.BAState(
        cam_T=graph.cam_T0, mot_T=graph.mot_T0,
        Xs=graph.Xs0, Ls_U=graph.Ls_U0, Ls_w=graph.Ls_w0,
        Xd=graph.Xd0, Ld_U=graph.Ld_U0, Ld_w=graph.Ld_w0,
    )
    cost0 = bb._cost_only(graph, state0, w)

    def cond(c):
        _, _, _, _, it, done = c
        return (it < max_iters) & ~done

    def body(c):
        state, lam, nu, cost, it, done = c
        x, _, gain_den = dense_schur_step(graph, state, w, lam, meta)
        new_state = bb._retract(state, x)
        new_cost = bb._cost_only(graph, new_state, w)
        rho = (cost - new_cost) / jnp.maximum(gain_den, 1e-20)
        ok = jnp.isfinite(new_cost) & (rho > 0)
        gain = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        state = jax.tree_util.tree_map(
            lambda a, bnew: jnp.where(ok, bnew, a), state, new_state
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
