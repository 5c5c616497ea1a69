"""Tracking: the per-frame dynamic-SLAM pipeline.

Array re-design of the reference ``Tracking`` (/root/reference/src/Tracking.cc,
5541 LoC of scalar loops) as a sequence of jitted, fixed-shape device stages
with thin host glue for label bookkeeping:

  GrabImageRGBD (Tracking.cc:179)  ->  Tracking.grab_rgbd
    depth preprocess (:195-219)        preprocess_depth (jit)
    UpdateMask (:4730)                 update_mask (stage 2)
    Frame(...) feature extraction      build-candidates + select_* (jit)
    inherit from last frame (:269-473) _inherit_* (jit)
  Track (:1028)
    camera: init model (:2738) + joint flow+pose solve (Optimizer.cc:6409)
    objects: scene flow (:1989), DynObjTracking (:2077), per-object joint
             flow+motion solves (Optimizer.cc:7603) vmapped over objects
    RenewFrameInfo (:3959)
    Map appends (:1605-1786), metric logging, BA triggers

Fixed capacities (static shapes) come from the reference's own caps:
1200 static points (MaxTrackPointBG), 400 static lines, 800 object points
per object (MaxTrackPointOBJ), 100 object lines per object.
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io import native as _native
from ..ops import geometry, lie, ransac
from ..ops.geometry import Intrinsics
from ..solvers import frame_solvers as fs
from ..utils.config import KITTI, OMD, Settings
from . import frame as fr
from . import frame_host as fh
from .map_state import MapState

_HI = jax.lax.Precision.HIGHEST
_EYE4 = np.eye(4, dtype=np.float32)


def _np_backproject(K: Intrinsics, uv: np.ndarray, z: np.ndarray):
    fx, fy, cx, cy = float(K.fx), float(K.fy), float(K.cx), float(K.cy)
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def _np_world_points(K: Intrinsics, T_cw: np.ndarray, uv: np.ndarray,
                     z: np.ndarray):
    Xc = _np_backproject(K, uv, z)
    T_wc = np.linalg.inv(T_cw)
    return (Xc @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)


def _np_world_lines(K: Intrinsics, T_cw: np.ndarray, uv4: np.ndarray,
                    d2: np.ndarray):
    s = _np_world_points(K, T_cw, uv4[..., :2], d2[..., 0])
    e = _np_world_points(K, T_cw, uv4[..., 2:], d2[..., 1])
    return np.concatenate([s, e], axis=-1)


def _np_plucker(p: np.ndarray, q: np.ndarray):
    d = q - p
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    d = d / np.maximum(n, 1e-12)
    return np.concatenate([np.cross(p, d), d], axis=-1).astype(np.float32)


def _np_preprocess_depth(depth_raw: np.ndarray, choose_data: int,
                         factor: float, bf: float) -> np.ndarray:
    """Host mirror of frame.preprocess_depth -- renewal/map logic reads this
    host copy instead of pulling the dense plane back from the device."""
    d = depth_raw if depth_raw.dtype == np.float32 else depth_raw.astype(
        np.float32
    )
    out = _native.depth_preprocess(d, choose_data, factor, bf)
    if out is not None:
        return out
    if choose_data == KITTI:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (np.float32(bf * factor) / d).astype(np.float32)
        # d <= 0 (invalid or negative disparity) -> 0
        np.place(out, ~np.isfinite(out) | (out < 0), 0.0)
    elif choose_data == OMD:
        out = np.where(d < 0, np.float32(0.0), d) * np.float32(1.0 / factor)
    else:
        # VirtualKITTI (3) matches neither reference branch: values stay
        # unscaled, negatives -> 0 (Tracking.cc:199-216)
        out = np.where(d < 0, np.float32(0.0), d)
    return out


def obj_pose_parsing_kt(row: np.ndarray) -> np.ndarray:
    """KITTI object-pose row -> 4x4 pose in CAMERA coordinates
    (``ObjPoseParsingKT``, /root/reference/src/Tracking.cc:3134-3241):
    row = [frame, track_id, B1..B4, t1, t2, t3, yaw].  The reference sets
    y = yaw + pi/2, x = z = 0 (Tracking.cc:3147-3150) and composes
    R = Ry*Rx*Rz (:3172-3180), which with x=z=0 reduces to Ry(yaw + pi/2);
    t = row[6:9] is used directly (:3232-3235)."""
    t = row[6:9].astype(np.float64)
    yaw = float(row[9]) + np.pi / 2.0
    cy, sy = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array(
        [[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]], np.float32
    )
    pose[:3, 3] = t.astype(np.float32)
    return pose


def obj_pose_parsing_ox(row: np.ndarray,
                        origin_inv: np.ndarray = None) -> np.ndarray:
    """OMD object-pose row -> 4x4 origin-aligned WORLD pose
    (``ObjPoseParsingOX``, /root/reference/src/Tracking.cc:3243-3323):
    row = [frame, id, t(3), axis-angle(3)]; the pose is composed as
    inv(origin) @ [Rodrigues(aa), t] so it lives in the frame-0 camera
    frame like the internal trajectory."""
    pose = np.eye(4, dtype=np.float32)
    t = row[2:5].astype(np.float64)
    aa = row[5:8].astype(np.float64)
    angle = float(np.linalg.norm(aa))
    if angle > 0:
        x, y, z = aa / angle
        s, c = np.sin(angle), np.cos(angle)
        v = 1.0 - c
        pose[:3, :3] = np.array([
            [x * x * v + c, x * y * v - z * s, x * z * v + y * s],
            [x * y * v + z * s, y * y * v + c, y * z * v - x * s],
            [x * z * v - y * s, y * z * v + x * s, z * z * v + c],
        ], np.float32)
    pose[:3, 3] = t.astype(np.float32)
    if origin_inv is not None:
        pose = (np.linalg.inv(origin_inv) @ pose).astype(np.float32)
    return pose


class _FrameDetections:
    """FAST corners + line segments packed in ONE device buffer.

    The detector outputs come home in a single async transfer (six
    per-leaf copies would each cost host issue time); the host slices
    lazily."""

    __slots__ = ("buf", "n_fast", "n_lines", "_np", "_thread", "_err")

    def __init__(self, buf, n_fast: int, n_lines: int):
        self.buf = buf
        self.n_fast = n_fast
        self.n_lines = n_lines
        self._np = None
        self._err = None
        # pull on a background thread from the moment of dispatch, so the
        # host never blocks on the device before it needs the result
        self._thread = threading.Thread(target=self._pull, daemon=True)
        self._thread.start()

    def _pull(self):
        try:
            self._np = np.asarray(self.buf)
        except Exception as e:               # surfaced at first access
            self._err = e

    def _host(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._err is not None:
                raise self._err
        return self._np

    @property
    def has_fast(self):
        return self.n_fast > 0

    @property
    def has_lines(self):
        return self.n_lines > 0

    def fast(self):
        """(uv (N,2), score (N,), valid (N,) bool)."""
        b, n = self._host(), self.n_fast
        return (b[:2 * n].reshape(n, 2), b[2 * n:3 * n],
                b[3 * n:4 * n] > 0.5)

    def lines(self):
        """(uv4 (M,4), valid (M,) bool)."""
        b, m = self._host(), self.n_lines
        o = 4 * self.n_fast
        return b[o:o + 4 * m].reshape(m, 4), b[o + 5 * m:o + 6 * m] > 0.5


# jitted per-frame program sets shared across Tracking instances with
# equal _jit_key()s (see _build_jits); detector programs likewise
_TRACK_JIT_MEMO: dict = {}
_DETECT_JIT_MEMO: dict = {}


class Tracking:
    """Host orchestrator holding per-sequence state, driving jitted stages."""

    def __init__(self, settings: Settings):
        self.cfg = settings
        self.K = Intrinsics(
            jnp.float32(settings.fx), jnp.float32(settings.fy),
            jnp.float32(settings.cx), jnp.float32(settings.cy),
        )
        # capacities
        self.NS = int(settings.max_track_point_bg)       # static points
        self.NLS = int(settings.max_static_lines)        # static lines
        self.P_OBJ = int(settings.max_track_point_obj)   # points per object
        self.L_OBJ = int(settings.max_object_lines)      # lines per object
        self.MAXO = int(settings.max_objects)
        self.NO = self.MAXO * self.P_OBJ                 # total object points
        self.NLO = self.MAXO * self.L_OBJ
        self.N_CAND = 3000                               # static candidates
        self.NL_CAND = max(2 * self.NLS, 64)             # line candidates

        self.f_id = 0
        self.max_id = 1                                  # object id counter
        self.velocity: Optional[np.ndarray] = None       # mVelocity
        self.origin_inv: Optional[np.ndarray] = None     # mOriginInv
        self.last: Optional[dict] = None                 # last frame dict
        self.last_meta: dict = {"sem_position": [], "mod_label": [],
                                "obj_stat": [], "obj_motion": {}}
        self.map = MapState()
        self.mask_np: Optional[np.ndarray] = None        # current (possibly
                                                         # recovered) mask
        self.last_mask_np: Optional[np.ndarray] = None   # mSegMapLast
        self.last_flow_np: Optional[np.ndarray] = None   # mFlowMapLast
        self._detect_jits: dict = {}                     # (fast?,lines?)->jit
        self._inflight: Optional[dict] = None            # pipelined frame
        self._deferred_push: Optional[tuple] = None      # lazy map push
        self._res = None                                 # ResidentDriver

        self._build_jits()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Finish any in-flight pipelined frame (pull + renew + map push +
        BA triggers) and drain the resident stream.  Idempotent; called
        automatically at the start of the next frame and by any
        map/results consumer."""
        if self._res is not None:
            self._res.drain_all()
        self._run_deferred_push()   # always older than the inflight frame
        if self._inflight is not None:
            fl = self._inflight
            self._inflight = None
            self._track_finish(fl)

    def _run_deferred_push(self) -> None:
        if self._deferred_push is not None:
            args = self._deferred_push
            self._deferred_push = None
            self._push_map(*args)

    def sync_host_state(self) -> None:
        """Write any device-resident state back to the host ``last`` dict
        (for checkpointing / mode transitions)."""
        if self._res is not None:
            self._res.exit()
            self._res = None

    # ------------------------------------------------------------------
    # jitted stages
    # ------------------------------------------------------------------
    def _jit_key(self):
        """Everything the _build_jits closures capture that shapes the
        traced programs: intrinsics, the solver/RANSAC config scalars,
        and the static capacities.  Two Tracking instances with equal
        keys produce identical programs, so the jitted callables (and
        their compiled executables) are shared via _TRACK_JIT_MEMO —
        without this every System() construction recompiles the whole
        per-frame program set (tens of seconds per instance on CPU CI)."""
        cfg = self.cfg
        return (
            float(self.K.fx), float(self.K.fy),
            float(self.K.cx), float(self.K.cy),
            float(cfg.rp_thres), float(cfg.flow_prior_info_cam),
            float(cfg.flow_prior_info_obj), int(cfg.lm_iterations),
            float(cfg.lm_rel_tol), bool(cfg.use_lines),
            float(cfg.sf_mg_thres), float(cfg.pnp_reproj_error),
            int(cfg.pnp_iterations),
            self.NS, self.NLS, self.P_OBJ, self.L_OBJ,
        )

    _MEMO_NAMES = (
        "_cam_solve", "_obj_solve", "_obj_init_solve", "_cam_pose_only",
        "_obj_pose_only", "_init_cam", "_fused_track", "_fused_cam_only",
    )

    def _build_jits(self):
        memo_key = self._jit_key()
        cached = _TRACK_JIT_MEMO.get(memo_key)
        if cached is not None:
            for name, fn in cached.items():
                setattr(self, name, fn)
            return
        self._build_jits_uncached()
        _TRACK_JIT_MEMO[memo_key] = {
            name: getattr(self, name) for name in self._MEMO_NAMES
        }

    def _build_jits_uncached(self):
        cfg = self.cfg
        K = self.K

        def cam_solve(T_init, T_wl, pts, lns):
            return fs.solve_flow_pose(
                T_init, T_wl, pts, lns, K,
                rp_thres=cfg.rp_thres,
                flow_prior_info=cfg.flow_prior_info_cam,
                line_prior_info=cfg.flow_prior_info_cam,
                max_iterations=cfg.lm_iterations,
                use_lines=cfg.use_lines,
                rel_tol=cfg.lm_rel_tol,
            )

        self._cam_solve = jax.jit(cam_solve)

        def obj_solve_one(T_init, T_wl, pts, lns, use_lines):
            return fs.solve_flow_pose(
                T_init, T_wl, pts, lns, K,
                rp_thres=cfg.rp_thres,
                flow_prior_info=cfg.flow_prior_info_obj,
                line_prior_info=cfg.flow_prior_info_obj,
                max_iterations=cfg.lm_iterations,
                use_lines=use_lines and cfg.use_lines,
                rel_tol=cfg.lm_rel_tol,
            )

        # use_lines static: frames with no valid object lines compile to a
        # variant without any line math (the common case)
        self._obj_solve = jax.jit(
            jax.vmap(obj_solve_one, in_axes=(0, None, 0, 0, None)),
            static_argnums=(4,),
        )

        def obj_init_and_solve(keys, models, T_wl, pts, lns, cur_uv, cur_d,
                               use_lines):
            """GetInitModelObj + the joint solve in ONE device chain (one
            host sync instead of two)."""
            T_inits, init_inl, init_n = jax.vmap(
                init_model_obj_one, in_axes=(0, 0, None, 0, 0, 0, 0, 0)
            )(keys, models, T_wl, pts.obs, pts.depth, cur_uv, cur_d,
              pts.valid)
            pts = pts._replace(valid=pts.valid & init_inl)
            res = jax.vmap(
                obj_solve_one, in_axes=(0, None, 0, 0, None)
            )(T_inits, T_wl, pts, lns, use_lines)
            return res, init_inl, init_n

        self._obj_init_solve = jax.jit(
            obj_init_and_solve, static_argnums=(7,)
        )

        def cam_pose_only(T_init, X_w, obs_uv, valid, lXs, lXe, lcoef, lval):
            return fs.solve_pose_only(
                T_init, X_w, obs_uv, valid, lXs, lXe, lcoef, lval, K,
                rp_thres=0.01, line_weight_thr=50,
                use_lines=cfg.use_lines,
            )

        self._cam_pose_only = jax.jit(cam_pose_only)
        self._obj_pose_only = jax.jit(
            jax.vmap(cam_pose_only, in_axes=(0, 0, 0, 0, 0, 0, 0, 0))
        )

        def _model_inliers(model, X_w, cur_uv, valid):
            proj = geometry.project(K, lie.transform_point(model, X_w))
            rpe = jnp.linalg.norm(cur_uv - proj, axis=-1)
            front = lie.transform_point(model, X_w)[:, 2] > 0
            return valid & front & (rpe < cfg.pnp_reproj_error)

        # GetInitModelCam's RANSAC budget: the reference runs up to 500
        # sequential AP3P iterations but terminates at 0.98 confidence
        # (Tracking.cc:2776-2778), i.e. a handful of iterations at typical
        # >0.5 inlier ratios.  Here every hypothesis is solved in parallel;
        # 128 simultaneous hypotheses exceed the reference's effective
        # sample count, with ``pnp_iterations`` as the upper bound.
        n_hyp_cam = max(min(int(cfg.pnp_iterations), 128), 8)
        n_hyp_obj = max(n_hyp_cam // 2, 8)

        def init_model_cam(key, velocity, T_lw, last_uv, last_depth,
                           cur_uv, cur_depth, valid):
            """GetInitModelCam (Tracking.cc:2738-2838): RANSAC init vs the
            const-velocity model; whichever has more inliers wins, and its
            inlier set becomes TemperalMatch_subset."""
            X_w = fr.world_points(K, T_lw, last_uv, last_depth)
            X_c = geometry.backproject(K, cur_uv, cur_depth)
            rs = ransac.ransac_rigid_init(
                X_w, cur_uv, X_c, valid & (cur_depth > 0), K, key,
                n_hypotheses=n_hyp_cam, reproj_thresh=cfg.pnp_reproj_error,
            )
            model = velocity @ T_lw
            mm_inl = _model_inliers(model, X_w, cur_uv, valid)
            mm_n = jnp.sum(mm_inl.astype(jnp.int32))
            use_ransac = rs.n_inliers > mm_n
            T_init = jnp.where(use_ransac, rs.pose, model)
            subset = jnp.where(use_ransac, rs.inliers, mm_inl)
            return T_init, subset

        self._init_cam = jax.jit(init_model_cam)

        def init_model_obj_one(key, model, T_lw, last_uv, last_depth,
                               cur_uv, cur_depth, valid):
            """GetInitModelObj (Tracking.cc:2841-2972): same recipe on one
            object's points; ``model`` is the propagated last motion."""
            X_w = fr.world_points(K, T_lw, last_uv, last_depth)
            X_c = geometry.backproject(K, cur_uv, cur_depth)
            rs = ransac.ransac_rigid_init(
                X_w, cur_uv, X_c, valid & (cur_depth > 0), K, key,
                n_hypotheses=n_hyp_obj, reproj_thresh=cfg.pnp_reproj_error,
            )
            mm_inl = _model_inliers(model, X_w, cur_uv, valid)
            mm_n = jnp.sum(mm_inl.astype(jnp.int32))
            use_ransac = rs.n_inliers > mm_n
            T_init = jnp.where(use_ransac, rs.pose, model)
            subset = jnp.where(use_ransac, rs.inliers, mm_inl)
            return T_init, subset, jnp.maximum(rs.n_inliers, mm_n)

        # ------------------------------------------------------------------
        # The FUSED frame step: camera init -> joint camera solve -> scene
        # flow + per-object static test -> object init -> joint object
        # solves, ONE device chain with ONE consolidated host pull: every
        # blocking host sync costs a round trip whatever its payload.  The
        # reference's pipeline
        # order (Tracking.cc:1028-1558) has a host-side label-grouping step
        # between the camera and object solves, which previously forced two
        # syncs.  The grouping is moved BEFORE the dispatch (it only needs
        # the semantic mask, not the pose) and the pose-dependent static
        # test (GetSceneFlowObj + DynObjTracking's scene-flow fraction,
        # Tracking.cc:1989-2075/:2528-2560) is computed on device and
        # returned as a per-bucket fraction, applied on host afterwards.
        # ------------------------------------------------------------------
        def scene_flow_static_frac(pose, T_wl, o_obs, o_depth, o_cur_uv,
                                   o_cur_d, sf_valid):
            """Fraction of each object's points whose x-z world scene flow
            is below SFMgThres (y ignored -- Tracking.cc:2537)."""
            Xp_w = lie.transform_point(
                T_wl, geometry.backproject(K, o_obs, o_depth)
            )
            T_wc = jnp.linalg.inv(pose)
            Xc_w = lie.transform_point(
                T_wc, geometry.backproject(K, o_cur_uv, o_cur_d)
            )
            f3 = Xc_w - Xp_w
            sfn = jnp.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
            v = sf_valid.astype(jnp.float32)
            n = jnp.maximum(jnp.sum(v, axis=-1), 1.0)
            small = v * (sfn < cfg.sf_mg_thres).astype(jnp.float32)
            return jnp.sum(small, axis=-1) / n

        def fused_cam(key, velocity, T_lw,
                      s_obs, s_flow0, s_depth, s_cur_uv, s_cur_d, s_valid,
                      l_obs, l_flow0, l_depth, l_valid):
            T_init, subset = init_model_cam(
                key, velocity, T_lw, s_obs, s_depth, s_cur_uv, s_cur_d,
                s_valid,
            )
            pts = fs.PointBundle(obs=s_obs, flow0=s_flow0, depth=s_depth,
                                 valid=subset)
            lns = fs.LineBundle(obs=l_obs, flow0=l_flow0, depth=l_depth,
                                valid=l_valid)
            T_wl = jnp.linalg.inv(T_lw)
            res = cam_solve(T_init, T_wl, pts, lns)
            return res, T_wl

        def fused_track(key, velocity, T_lw,
                        s_obs, s_flow0, s_depth, s_cur_uv, s_cur_d, s_valid,
                        l_obs, l_flow0, l_depth, l_valid,
                        o_obs, o_flow0, o_depth, o_cur_uv, o_cur_d,
                        o_valid, o_sfvalid,
                        ol_obs, ol_flow0, ol_depth, ol_valid,
                        H_prev, use_obj_lines):
            cam, T_wl = fused_cam(
                key, velocity, T_lw,
                s_obs, s_flow0, s_depth, s_cur_uv, s_cur_d, s_valid,
                l_obs, l_flow0, l_depth, l_valid,
            )
            pose = cam.pose
            static_frac = scene_flow_static_frac(
                pose, T_wl, o_obs, o_depth, o_cur_uv, o_cur_d, o_sfvalid
            )
            # T_init per object: G = T_cw_cur . H_last (motion-model branch
            # of GetInitModelObj); H_prev is identity for new objects.
            T_models = jnp.einsum("ij,njk->nik", pose, H_prev)
            # per-lane keys folded by LANE INDEX (not split by lane count)
            # so the stream is identical for any bucket width MB -- keeps
            # the host and device-resident paths bit-compatible
            okeys = jax.vmap(
                lambda i: jax.random.fold_in(jax.random.fold_in(key, 7), i)
            )(jnp.arange(o_obs.shape[0]))
            T_is, init_inl, init_n = jax.vmap(
                init_model_obj_one, in_axes=(0, 0, None, 0, 0, 0, 0, 0)
            )(okeys, T_models, T_lw, o_obs, o_depth, o_cur_uv, o_cur_d,
              o_valid)
            opts = fs.PointBundle(obs=o_obs, flow0=o_flow0, depth=o_depth,
                                  valid=o_valid & init_inl)
            olns = fs.LineBundle(obs=ol_obs, flow0=ol_flow0, depth=ol_depth,
                                 valid=ol_valid)
            res = jax.vmap(obj_solve_one, in_axes=(0, None, 0, 0, None))(
                T_is, T_wl, opts, olns, use_obj_lines
            )
            return (pose, cam.flow, cam.line_flow, cam.point_inlier,
                    cam.line_inlier, res.pose, res.flow, res.line_flow,
                    res.point_inlier, res.line_inlier, init_n, static_frac)

        # Packed-argument wrappers: the ~30 per-frame input arrays are
        # concatenated into ONE flat f32 buffer on host (one push, one
        # argument) and sliced apart inside the jit -- slicing at static
        # offsets is free in XLA, while 30 separate device_put/argument
        # transfers would each cost host issue time.
        NS, NLS, P, L = self.NS, self.NLS, self.P_OBJ, self.L_OBJ

        def _unpack(buf, specs):
            out = []
            o = 0
            for (n, shape, kind) in specs:
                a = buf[o:o + n]
                o += n
                if shape is not None:
                    a = a.reshape(shape)
                if kind == "bool":
                    a = a > 0.5
                out.append(a)
            return out

        CAM_SPECS = [
            (16, (4, 4), "f"), (16, (4, 4), "f"),
            (NS * 2, (NS, 2), "f"), (NS * 2, (NS, 2), "f"), (NS, None, "f"),
            (NS * 2, (NS, 2), "f"), (NS, None, "f"), (NS, None, "bool"),
            (NLS * 4, (NLS, 4), "f"), (NLS * 4, (NLS, 4), "f"),
            (NLS * 2, (NLS, 2), "f"), (NLS, None, "bool"),
        ]

        def _obj_specs(MB):
            return [
                (MB * P * 2, (MB, P, 2), "f"), (MB * P * 2, (MB, P, 2), "f"),
                (MB * P, (MB, P), "f"), (MB * P * 2, (MB, P, 2), "f"),
                (MB * P, (MB, P), "f"), (MB * P, (MB, P), "bool"),
                (MB * P, (MB, P), "bool"),
                (MB * L * 4, (MB, L, 4), "f"), (MB * L * 4, (MB, L, 4), "f"),
                (MB * L * 2, (MB, L, 2), "f"), (MB * L, (MB, L), "bool"),
                (MB * 16, (MB, 4, 4), "f"),
            ]

        def _pack_out(arrs):
            """Flatten the output pytree into ONE f32 vector: the frame's
            results come home in a single async transfer instead of ~12
            per-leaf copies (each costs host issue time)."""
            return jnp.concatenate(
                [jnp.ravel(a).astype(jnp.float32) for a in arrs]
            )

        def fused_track_packed(key, buf, MB, use_obj_lines):
            cam_args = _unpack(buf, CAM_SPECS + _obj_specs(MB))
            return _pack_out(fused_track(key, *cam_args, use_obj_lines))

        self._fused_track = jax.jit(fused_track_packed,
                                    static_argnums=(2, 3))

        def fused_cam_only_packed(key, buf):
            cam, _ = fused_cam(key, *_unpack(buf, CAM_SPECS))
            return _pack_out((cam.pose, cam.flow, cam.line_flow,
                              cam.point_inlier, cam.line_inlier))

        self._fused_cam_only = jax.jit(fused_cam_only_packed)

    def _out_specs(self, MB):
        """(size, shape, kind) rows for unpacking the fused result buffer;
        order mirrors fused_track's return tuple."""
        NS, NLS, P, L = self.NS, self.NLS, self.P_OBJ, self.L_OBJ
        specs = [
            (16, (4, 4), "f"), (NS * 2, (NS, 2), "f"),
            (NLS * 4, (NLS, 4), "f"), (NS, None, "bool"),
            (NLS, None, "bool"),
        ]
        if MB:
            specs += [
                (MB * 16, (MB, 4, 4), "f"), (MB * P * 2, (MB, P, 2), "f"),
                (MB * L * 4, (MB, L, 4), "f"), (MB * P, (MB, P), "bool"),
                (MB * L, (MB, L), "bool"), (MB, None, "int"),
                (MB, None, "f"),
            ]
        return specs

    @staticmethod
    def _np_unpack(buf, specs):
        out = []
        o = 0
        for (n, shape, kind) in specs:
            a = buf[o:o + n]
            o += n
            if shape is not None:
                a = a.reshape(shape)
            if kind == "bool":
                a = a > 0.5
            elif kind == "int":
                a = a.astype(np.int32)
            out.append(a)
        return out



    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def grab_rgbd(
        self,
        gray: np.ndarray,
        depth_raw: np.ndarray,
        flow: np.ndarray,
        mask: np.ndarray,
        gt_pose: np.ndarray,
        obj_poses_gt: List[np.ndarray],
        timestamp: float,
        n_images: int,
        line_detections: Optional[np.ndarray] = None,
        point_detections: Optional[np.ndarray] = None,
        next_gray: Optional[np.ndarray] = None,
        next_gray2: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Process one frame; returns the estimated camera pose T_cw.

        ``line_detections``: optional (L, 4) array of detected segments (the
        LSD stage output; injectable for testing, SURVEY.md 7.2 item 7).
        ``point_detections``: optional (P, 2) detected corners (FAST).
        ``next_gray``: optional grayscale of frame t+1 (prefetch hint);
        its detectors run during this frame's solve window.
        """
        cfg = self.cfg
        h, w = gray.shape
        timing = np.zeros(5, np.float32)
        import time as _time

        # --- stop frame semantics (Tracking.cc:184) ---
        stop_frame = (
            cfg.stop_frame if cfg.stop_frame is not None else n_images - 1
        )

        # --- GT pose handling (Tracking.cc:477-489) ---
        if self.f_id == 0 or self.origin_inv is None:
            self.origin_inv = np.asarray(gt_pose, np.float32)
            pose_gt = np.linalg.inv(self.origin_inv).astype(np.float32)
        else:
            pose_gt = (
                np.linalg.inv(np.asarray(gt_pose, np.float32))
                @ self.origin_inv
            ).astype(np.float32)

        # --- device-resident steady loop (models/resident.py): the whole
        # pipeline runs as one jit against device state; host pushes
        # images, map rows stream back lagged.  Parity with the host path
        # is enforced by tests/test_resident.py. ---
        if ((cfg.resident_tracking or cfg.chained_tracking)
                and cfg.use_joint_optimization
                and self.f_id > 0
                and (self._res is not None or self.last is not None)):
            from .chained import ChainedDriver
            from .resident import ResidentDriver

            driver_cls = (
                ChainedDriver if cfg.chained_tracking else ResidentDriver
            )
            if driver_cls.eligible(cfg):
                gt_objs = [np.asarray(r, np.float32) for r in obj_poses_gt]
                if self._res is None:
                    self.flush()
                    self._res = driver_cls(self)
                    self._res.enter()
                kw = {}
                if cfg.chained_tracking:
                    kw["next_gray"] = next_gray
                    kw["next_gray2"] = next_gray2
                pose = self._res.track(
                    gray, depth_raw, flow, mask, pose_gt, gt_objs, timing,
                    self.f_id, n_images, stop_frame,
                    line_detections=line_detections,
                    point_detections=point_detections, **kw,
                )
                if self._res.state is None:   # exited (global BA at stop)
                    self._res = None
                self.f_id += 1
                return pose
        if self._res is not None:
            self._res.exit()
            self._res = None

        # --- detector dispatches (device, async).  Results are consumed
        # only by the renewal top-up, i.e. AFTER the frame's solve pull.
        # When the driver supplies ``next_image`` (the prefetcher has it on
        # disk anyway), frame t+1's detectors are dispatched DURING frame
        # t's solve window, so their results are host-resident before
        # frame t+1 even starts -- the detector stream leaves the critical
        # path entirely (SURVEY.md 2.3: batched front-end ahead of use). ---
        t0 = _time.perf_counter()
        need_fast = cfg.use_sample_fea == 0 and point_detections is None
        need_lines = line_detections is None and cfg.use_lines
        self._need_det = (need_fast, need_lines)
        pend = getattr(self, "_pending_det", None)
        if (pend is not None and pend[0] == self.f_id
                and pend[1] is not None
                and pend[1].has_fast == need_fast
                and pend[1].has_lines == need_lines):
            det = pend[1]
        else:
            det = self._dispatch_detectors(gray, need_fast, need_lines)
        self._pending_det = None
        self._next_gray = next_gray

        # renewal-independent image prep runs BEFORE the flush so it
        # overlaps the previous frame's in-flight device pull
        depth_now = _np_preprocess_depth(
            np.asarray(depth_raw, np.float32), cfg.choose_data,
            cfg.depth_map_factor, cfg.bf,
        )
        flow_np = np.ascontiguousarray(flow, dtype=np.float32)

        # --- finish the previous frame's in-flight work (pipelined mode).
        # Runs BEFORE this frame's images overwrite self.mask_np/depth_np;
        # by now the previous solve has had the whole inter-call gap to
        # complete and its packed result transfer has landed.  The map
        # push is DEFERRED past this frame's dispatch (it feeds nothing on
        # the tracking path) unless a BA trigger fires. ---
        if self._inflight is not None:
            fl_prev = self._inflight
            self._inflight = None
            self._track_finish(fl_prev, defer_push=True)

        # --- mask recovery (UpdateMask, Tracking.cc:4730-4810) ---
        self.mask_np = np.asarray(mask, np.int32).copy()
        if self.f_id > 0 and self.last is not None:
            self._update_mask()
        # host mirror of the preprocessed depth (no dense device->host
        # pull)
        self.depth_np = depth_now
        # object candidates come from the stride-4 mask grid, not the
        # detector (Frame.cc:769-809) -- selectable before any pull
        obj_tmp = fh.select_object_points(
            self.depth_np, flow_np, self.mask_np, cfg.th_depth_obj, self.NO,
        )
        timing[0] = (_time.perf_counter() - t0) * 1e3

        gt_objs = [np.asarray(r, np.float32) for r in obj_poses_gt]
        if self.f_id == 0 or self.last is None:
            t0 = _time.perf_counter()
            self._predispatch_next_detectors()
            stat_tmp, line_tmp, oline_tmp = self._finish_selection(
                det, point_detections, line_detections, flow_np, h, w,
            )
            timing[0] += (_time.perf_counter() - t0) * 1e3
            self._initialize(stat_tmp, line_tmp, obj_tmp,
                             oline_tmp, pose_gt, gt_objs)
            pose = np.asarray(self.last["pose"])
        else:
            fl = self._track_dispatch(
                flow_np, obj_tmp, pose_gt, gt_objs, timing, stop_frame,
                det, point_detections, line_detections,
            )
            # previous frame's map push overlaps this frame's device solve
            self._run_deferred_push()
            last_frame = (
                self.f_id >= stop_frame or self.f_id >= n_images - 1
            )
            if (cfg.pipelined_tracking and fl["legacy"] is None
                    and not last_frame):
                self._inflight = fl
                # 1-frame-lag return: this frame's pose lands in the map
                # when the next call (or flush) finishes it
                pose = np.asarray(self.last["pose"])
            else:
                pose = self._track_finish(fl)
        self.last_mask_np = self.mask_np.copy()
        self.last_flow_np = np.asarray(flow, np.float32)
        self.f_id += 1
        return pose

    # ------------------------------------------------------------------
    def _dispatch_detectors(self, gray, need_fast, need_lines):
        """Dispatch FAST + line detection on ``gray`` (async, one fused jit,
        one packed output buffer) and request its host copy."""
        if not (need_fast or need_lines):
            return None
        entry = self._detect_jits.get((need_fast, need_lines))
        if entry is None:
            from ..ops import fast as fast_ops, lines as line_ops

            fcfg = self._fast_cfg() if need_fast else None
            lcfg = self._line_cfg() if need_lines else None
            # detector programs depend only on the configs (shapes enter
            # via the traced image): share them across instances
            memo_key = (need_fast, need_lines, repr(fcfg), repr(lcfg))
            entry = _DETECT_JIT_MEMO.get(memo_key)
        if entry is None:
            n_fast = fcfg.n_features if need_fast else 0
            n_lines = (
                max(1, lcfg.n_octaves) * lcfg.max_lines if need_lines else 0
            )

            @jax.jit
            def run(g):
                parts = []
                if need_fast:
                    uv, sc, va = fast_ops.detect_keypoints(g, fcfg)
                    parts += [jnp.ravel(uv).astype(jnp.float32),
                              sc.astype(jnp.float32),
                              va.astype(jnp.float32)]
                if need_lines:
                    seg = line_ops.detect_lines(g, lcfg)
                    parts += [jnp.ravel(seg.uv4), seg.length,
                              seg.valid.astype(jnp.float32)]
                return jnp.concatenate(parts)

            entry = (run, n_fast, n_lines)
            _DETECT_JIT_MEMO[memo_key] = entry
        self._detect_jits[(need_fast, need_lines)] = entry
        run, n_fast, n_lines = entry
        buf = run(jnp.asarray(np.ascontiguousarray(gray)))
        buf.copy_to_host_async()
        return _FrameDetections(buf, n_fast, n_lines)

    def _predispatch_next_detectors(self):
        """If the driver prefetched frame t+1's image, run its detectors
        now (they ride the device queue behind this frame's solve)."""
        if getattr(self, "_next_gray", None) is None:
            return
        need_fast, need_lines = self._need_det
        if need_fast or need_lines:
            self._pending_det = (self.f_id + 1, self._dispatch_detectors(
                self._next_gray, need_fast, need_lines
            ))
        self._next_gray = None

    # ------------------------------------------------------------------
    def _fast_cfg(self):
        from ..ops import fast as fast_ops

        cfg = self.cfg
        return fast_ops.FastPyramidConfig(
            n_features=min(cfg.orb_n_features, self.N_CAND),
            scale_factor=cfg.orb_scale_factor,
            n_levels=cfg.orb_n_levels,
            ini_threshold=float(cfg.orb_ini_th_fast),
            min_threshold=float(cfg.orb_min_th_fast),
        )

    def _line_cfg(self):
        from ..ops import lines as line_ops

        cfg = self.cfg
        # min segment length 0.02*min(w,h), the reference's LSD option
        # (Lineextractor.cc:70); floored at 8 px for noise robustness.
        # n_octaves/mode follow the yaml line settings (Tracking.cc:113-118
        # hard-codes levels=2, extractor 0=LSD / 1=EDLines).
        # lsd_nfeatures caps the detection count (0 = unlimited);
        # lsd_refine=0 (LSD_REFINE_NONE) disables endpoint refinement.
        # lsd_scale (LSD's internal Gaussian-subsample factor) is
        # intentionally inert: the tiled-PCA detector has no subsample
        # stage -- its scale mechanism IS the octave pyramid
        # (line_levels/line_scale); documented in utils/config.py.
        min_len = max(8.0, 0.02 * min(cfg.width, cfg.height))
        base = line_ops.LineDetectConfig()
        return line_ops.LineDetectConfig(
            max_lines=self.NL_CAND,
            min_length=min_len,
            n_octaves=max(1, cfg.line_levels),
            mode=1 if cfg.line_extractor == 1 else 0,
            n_features=max(0, int(cfg.lsd_nfeatures)),
            refine_steps=0 if cfg.lsd_refine == 0 else base.refine_steps,
        )

    def _finish_selection(self, det, point_detections,
                          line_detections, flow_np, h, w):
        """Pull detector outputs (already host-cached after the big sync)
        and run the static point / static line / object line selections
        (Frame.cc:491-718, :814-875)."""
        cfg = self.cfg
        cand = np.zeros((self.N_CAND, 2), np.float32)
        cand_valid = np.zeros(self.N_CAND, bool)
        if det is not None and det.has_fast:
            d_uv, _, d_valid = det.fast()
            # keypoint undistortion (Frame::UndistortKeyPoints,
            # Frame.cc:1037-1081): identity when all coefficients are zero
            d_uv = geometry.undistort_points_np(
                d_uv, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3,
            )
            n = min(len(d_uv), self.N_CAND)
            cand[:n] = d_uv[:n]
            cand_valid[:n] = d_valid[:n]
        elif point_detections is not None and cfg.use_sample_fea == 0:
            n = min(len(point_detections), self.N_CAND)
            cand[:n] = point_detections[:n]
            cand_valid[:n] = True
        else:
            # constant per image size: cache (avoids a device round-trip
            # per frame)
            key_hw = (h, w, self.N_CAND)
            if getattr(self, "_grid_cache_key", None) != key_hw:
                self._grid_cache = np.asarray(
                    fr.grid_sample_uv(h, w, n_points=self.N_CAND)
                )
                self._grid_cache_key = key_hw
            cand = self._grid_cache
            cand_valid = np.ones(self.N_CAND, bool)

        if det is not None and det.has_lines:
            # the global collinear merge already ran on device inside
            # detect_lines; the host only compacts the valid rows
            d_uv4, d_val = det.lines()
            line_detections = d_uv4[d_val]
        lcand = np.zeros((self.NL_CAND, 4), np.float32)
        lcand_valid = np.zeros(self.NL_CAND, bool)
        if line_detections is not None and len(line_detections):
            n = min(len(line_detections), self.NL_CAND)
            lcand[:n] = line_detections[:n]
            lcand_valid[:n] = True

        stat_tmp = _native.select_static_points(
            cand, cand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_bg, self.NS,
        )
        if stat_tmp is None:
            stat_tmp = fh.select_static_points(
                cand, cand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_bg, self.NS,
            )
        line_tmp = _native.select_static_lines(
            lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_bg, self.NLS,
        )
        if line_tmp is None:
            line_tmp = fh.select_static_lines(
                lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_bg, self.NLS,
            )
        oline_tmp = _native.select_object_lines(
            lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_obj, self.NLO,
        )
        if oline_tmp is None:
            oline_tmp = fh.select_object_lines(
                lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_obj, self.NLO,
            )
        return stat_tmp, line_tmp, oline_tmp

    # ------------------------------------------------------------------
    def _update_mask(self):
        """Mask recovery (Tracking.cc:4730-4810): per last-frame semantic
        label, sample the current mask at the flow-warped object points; if
        the majority vote (over >= 100 samples) is background, the segmenter
        lost the object -- splat the last mask forward along the last flow."""
        last = self.last
        if self.last_mask_np is None or self.last_flow_np is None:
            return
        h, w = self.mask_np.shape
        sem = last["obj_sem"]
        valid = last["obj_valid"]
        corres = last["obj_corres"]
        for lab in np.unique(sem[valid & (sem > 0)]):
            idx = np.nonzero(valid & (sem == lab))[0]
            u = corres[idx, 0].astype(np.int32)
            v = corres[idx, 1].astype(np.int32)
            inb = (u > 0) & (u < w) & (v > 0) & (v < h)
            if inb.sum() < 100:
                continue
            samples = self.mask_np[v[inb], u[inb]]
            vals, counts = np.unique(samples, return_counts=True)
            if vals[np.argmax(counts)] != 0:
                continue
            # splat: current mask at (pixel + last flow) = label
            ys, xs = np.nonzero(self.last_mask_np == lab)
            fx = self.last_flow_np[ys, xs, 0].astype(np.int32)
            fy = self.last_flow_np[ys, xs, 1].astype(np.int32)
            nx, ny = xs + fx, ys + fy
            ok = (nx > 0) & (nx < w) & (ny > 0) & (ny < h)
            self.mask_np[ny[ok], nx[ok]] = lab

    # ------------------------------------------------------------------
    def _initialize(self, stat_tmp, line_tmp, obj_tmp,
                    oline_tmp, pose_gt, gt_objs):
        """First frame (Tracking.cc:1888-1984): identity pose, stash features
        + 3D, push frame-0 map entries."""
        s_uv, s_d, s_f, s_c, s_v = stat_tmp
        l_uv, l_d, l_f, l_c, l_v = line_tmp
        o_uv, o_d, o_f, o_c, o_s, o_v = obj_tmp
        ol_uv, ol_d, ol_f, ol_c, ol_s, ol_v = oline_tmp

        pose = _EYE4
        stat_3d = _np_world_points(self.K, pose, s_uv, s_d)
        line_3d = _np_world_lines(self.K, pose, l_uv, l_d)
        obj_3d = _np_world_points(self.K, pose, o_uv, o_d)
        oline_3d = _np_world_lines(self.K, pose, ol_uv, ol_d)

        self.last = dict(
            pose=_EYE4.copy(), pose_gt=pose_gt,
            stat_uv=np.asarray(s_uv), stat_depth=np.asarray(s_d),
            stat_flow=np.asarray(s_f), stat_corres=np.asarray(s_c),
            stat_valid=np.asarray(s_v), stat_3d=np.asarray(stat_3d),
            line_uv=np.asarray(l_uv), line_depth=np.asarray(l_d),
            line_flow=np.asarray(l_f), line_corres=np.asarray(l_c),
            line_valid=np.asarray(l_v), line_3d=np.asarray(line_3d),
            obj_uv=np.asarray(o_uv), obj_depth=np.asarray(o_d),
            obj_flow=np.asarray(o_f), obj_corres=np.asarray(o_c),
            obj_sem=np.asarray(o_s), obj_valid=np.asarray(o_v),
            obj_3d=np.asarray(obj_3d),
            obj_label=np.full(self.NO, -2, np.int32),
            oline_uv=np.asarray(ol_uv), oline_depth=np.asarray(ol_d),
            oline_flow=np.asarray(ol_f), oline_corres=np.asarray(ol_c),
            oline_sem=np.asarray(ol_s), oline_valid=np.asarray(ol_v),
            oline_3d=np.asarray(oline_3d),
            oline_label=np.full(self.NLO, -2, np.int32),
            gt_objs=gt_objs,
        )
        self.last_meta = {"sem_position": [], "mod_label": [],
                          "obj_stat": [], "obj_motion": {}}

        # frame-0 map entries (Initialization, Tracking.cc:1921-1954):
        # features + identity camera poses (GT identity: origin-aligned)
        m = self.map
        st = self.last
        m.stat_uv.append(st["stat_uv"]); m.stat_depth.append(st["stat_depth"])
        m.stat_3d.append(st["stat_3d"]); m.stat_valid.append(st["stat_valid"])
        m.stat_asso.append(np.full(self.NS, -1, np.int32))
        m.line_uv.append(st["line_uv"]); m.line_depth.append(st["line_depth"])
        m.line_3d.append(st["line_3d"]); m.line_valid.append(st["line_valid"])
        m.line_asso.append(np.full(self.NLS, -1, np.int32))
        m.line_plucker.append(_np_plucker(st["line_3d"][:, :3], st["line_3d"][:, 3:]))
        m.dyn_uv.append(st["obj_uv"]); m.dyn_depth.append(st["obj_depth"])
        m.dyn_3d.append(st["obj_3d"]); m.dyn_valid.append(st["obj_valid"])
        m.dyn_asso.append(np.full(self.NO, -1, np.int32))
        m.dyn_label.append(st["obj_label"])
        m.dline_uv.append(st["oline_uv"]); m.dline_depth.append(st["oline_depth"])
        m.dline_3d.append(st["oline_3d"]); m.dline_valid.append(st["oline_valid"])
        m.dline_asso.append(np.full(self.NLO, -1, np.int32))
        m.dline_label.append(st["oline_label"])
        m.dline_plucker.append(_np_plucker(st["oline_3d"][:, :3], st["oline_3d"][:, 3:]))
        m.camera_poses.append(_EYE4.copy())
        m.camera_poses_rf.append(_EYE4.copy())
        m.camera_poses_gt.append(_EYE4.copy())

    # ------------------------------------------------------------------
    def _track(self, flow_np, obj_tmp, pose_gt, gt_objs, timing, stop_frame,
               det, point_detections, line_detections):
        return self._track_finish(self._track_dispatch(
            flow_np, obj_tmp, pose_gt, gt_objs, timing, stop_frame,
            det, point_detections, line_detections,
        ))

    def _track_dispatch(self, flow_np, obj_tmp, pose_gt, gt_objs, timing,
                        stop_frame, det, point_detections, line_detections):
        """Pre-pull half of the frame: inherit, group, dispatch the fused
        device chain, run the detector-dependent selections.  Returns the
        in-flight frame dict consumed by :meth:`_track_finish`; in
        pipelined mode the finish runs at the START of the next call, so
        the solve's device round trip overlaps the inter-frame gap."""
        import time as _time

        cfg = self.cfg
        last = self.last
        h, w = self.mask_np.shape

        # ---- inherit from last frame (host; Tracking.cc:269-473) ----
        (s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d,
         ol_sem) = fh.inherit(
            last["stat_corres"], last["line_corres"], last["obj_corres"],
            last["oline_corres"], self.depth_np, self.mask_np,
            cfg.th_depth_obj,
        )
        s_v = last["stat_valid"]
        l_v = last["line_valid"]
        o_v = last["obj_valid"]
        ol_v = last["oline_valid"]

        T_lw_np = last["pose"]
        last_s_valid = s_v & (last["stat_depth"] > 0) & (s_d > 0)
        line_ok = fh.line_track_filter(l_uv, l_v, self.depth_np, self.mask_np)
        l_use = l_v & (last["line_depth"].min(axis=-1) > 0) & line_ok
        velocity_np = self.velocity if self.velocity is not None else _EYE4
        key = jax.random.PRNGKey(self.f_id)

        # ---- group objects by semantic label (host, PRE-dispatch;
        # the mask-only parts of DynObjTracking: Tracking.cc:2112-2523) ----
        t0 = _time.perf_counter()
        sf_valid = (
            o_v & last["obj_valid"] & (last["obj_sem"] > 0) & (o_sem > 0)
        )
        groups = self._group_objects(
            o_uv, o_d, o_sem, sf_valid, ol_uv, ol_sem, ol_v
        )
        buckets = self._build_buckets(groups, o_uv, o_d, ol_uv, sf_valid)
        timing[2] = (_time.perf_counter() - t0) * 1e3

        t0 = _time.perf_counter()
        stat_tmp = line_tmp = oline_tmp = None
        if cfg.use_joint_optimization:
            # ======= ONE fused device dispatch + ONE consolidated pull ====
            outs = self._dispatch_fused(
                key, velocity_np, T_lw_np, last, s_uv, s_d, last_s_valid,
                l_use, buckets,
            )
            outs.copy_to_host_async()
            # Pull on a background thread, started at dispatch: the host's
            # selection/renewal work overlaps the round trip instead of
            # blocking on the device.
            pull = {"np": None, "err": None}

            def _pull(outs=outs, pull=pull):
                try:
                    pull["np"] = np.asarray(outs)
                except Exception as e:       # surfaced at join time
                    pull["err"] = e

            pull_thread = threading.Thread(target=_pull, daemon=True)
            pull_thread.start()
            # overlap: the renewal selections consume only the DETECTOR
            # outputs, which the device finished before the solve started
            # (dispatch order) and whose transfers were requested at
            # dispatch -- so this host work runs while the solve computes
            stat_tmp, line_tmp, oline_tmp = self._finish_selection(
                det, point_detections, line_detections, flow_np, h, w,
            )
            self._predispatch_next_detectors()
            legacy = None
        else:
            pull = pull_thread = None
            # bJoint=false: PoseOptimizationNewWithLines
            # (Optimizer.cc:5900) on fixed last-frame 3D structure, with
            # the reference's Gaussian depth-noise injection
            # (UnprojectStereoStat(.., addnoise=1), Optimizer.cc:5982;
            # Frame.cc:1140-1150, sigma = z^2/(725*0.5)*0.15).
            T_init, subset = self._init_cam(
                key, jnp.asarray(velocity_np), jnp.asarray(T_lw_np),
                jnp.asarray(last["stat_uv"]), jnp.asarray(last["stat_depth"]),
                jnp.asarray(s_uv), jnp.asarray(s_d),
                jnp.asarray(last_s_valid),
            )
            depth_n = last["stat_depth"]
            if cfg.nonjoint_add_noise:
                nrng = np.random.default_rng(self.f_id)
                sigma = depth_n * depth_n / (725.0 * 0.5) * 0.15
                depth_n = (
                    depth_n + sigma * nrng.standard_normal(depth_n.shape)
                ).astype(np.float32)
            X_w = _np_world_points(
                self.K, T_lw_np, last["stat_uv"], depth_n
            )
            l3d = last["line_3d"]
            lcoef = np.asarray(geometry.infinite_line_image(
                jnp.asarray(l_uv[:, :2]), jnp.asarray(l_uv[:, 2:])
            ))
            res = self._cam_pose_only(
                T_init, jnp.asarray(X_w), jnp.asarray(s_uv), subset,
                jnp.asarray(l3d[:, :3]), jnp.asarray(l3d[:, 3:]),
                jnp.asarray(lcoef), jnp.asarray(l_use),
            )
            pose_np, stat_track_ok, line_track_ok = jax.device_get(
                (res.pose, res.point_inlier, res.line_inlier)
            )
            obj_pulled = self._dispatch_objects_legacy(
                key, pose_np, T_lw_np, buckets, len(groups)
            )
            self._predispatch_next_detectors()
            outs = None
            legacy = (pose_np, stat_track_ok, line_track_ok, obj_pulled)

        return dict(
            outs=outs, legacy=legacy, pull=pull, pull_thread=pull_thread,
            buckets=buckets, groups=groups,
            last=last, s_uv=s_uv, s_d=s_d, l_uv=l_uv, l_d=l_d,
            o_uv=o_uv, o_d=o_d, o_sem=o_sem,
            ol_uv=ol_uv, ol_d=ol_d, ol_sem=ol_sem, ol_v=ol_v,
            stat_tmp=stat_tmp, line_tmp=line_tmp, oline_tmp=oline_tmp,
            det=det, point_detections=point_detections,
            line_detections=line_detections,
            flow_np=flow_np, obj_tmp=obj_tmp, pose_gt=pose_gt,
            gt_objs=gt_objs, timing=timing, stop_frame=stop_frame,
            f_id=self.f_id, h=h, w=w,
            depth_np=self.depth_np, mask_np=self.mask_np,
            t_disp=(_time.perf_counter() - t0),
        )

    def _track_finish(self, fin, defer_push=False):
        """Post-pull half: pull the fused results, apply scene-flow static
        decisions, commit objects, renew tracked features, push the map,
        and fire the BA triggers.  Reads the frame's depth/mask through
        ``fin`` (in pipelined mode ``self.depth_np`` may already hold the
        NEXT frame's data)."""
        import time as _time

        cfg = self.cfg
        (last, buckets, groups) = fin["last"], fin["buckets"], fin["groups"]
        s_uv, s_d, l_uv, l_d = fin["s_uv"], fin["s_d"], fin["l_uv"], fin["l_d"]
        o_uv, o_d, o_sem = fin["o_uv"], fin["o_d"], fin["o_sem"]
        ol_uv, ol_d, ol_sem, ol_v = (fin["ol_uv"], fin["ol_d"], fin["ol_sem"],
                                     fin["ol_v"])
        stat_tmp, line_tmp, oline_tmp = (fin["stat_tmp"], fin["line_tmp"],
                                         fin["oline_tmp"])
        flow_np, obj_tmp = fin["flow_np"], fin["obj_tmp"]
        pose_gt, gt_objs = fin["pose_gt"], fin["gt_objs"]
        timing, stop_frame = fin["timing"], fin["stop_frame"]
        f_id, h, w = fin["f_id"], fin["h"], fin["w"]

        t0 = _time.perf_counter()
        if fin["legacy"] is None:
            MB = 0 if buckets is None else buckets["pt_obs"].shape[0]
            fin["pull_thread"].join()
            if fin["pull"]["err"] is not None:
                raise fin["pull"]["err"]
            pulled = self._np_unpack(fin["pull"]["np"], self._out_specs(MB))
            if buckets is None:
                (pose_np, res_flow, res_lflow, stat_track_ok,
                 line_track_ok) = pulled
                obj_pulled = None
            else:
                (pose_np, res_flow, res_lflow, stat_track_ok, line_track_ok,
                 o_G, o_flow, o_lflow, o_pinl, o_linl, init_n,
                 static_frac) = pulled
                n_obj = len(groups)
                obj_pulled = (o_G[:n_obj], o_flow[:n_obj], o_lflow[:n_obj],
                              o_pinl[:n_obj], o_linl[:n_obj],
                              init_n[:n_obj], static_frac[:n_obj])
            # update tracked positions from optimized flow
            # (Optimizer.cc:6796)
            s_uv = np.where(
                stat_track_ok[:, None], last["stat_uv"] + res_flow, s_uv
            )
            l_uv = np.where(
                line_track_ok[:, None], last["line_uv"] + res_lflow, l_uv
            )
        else:
            pose_np, stat_track_ok, line_track_ok, obj_pulled = fin["legacy"]
        timing[1] = (fin["t_disp"] + _time.perf_counter() - t0) * 1e3

        # velocity (Tracking.cc:1177-1183)
        self.velocity = (pose_np @ np.linalg.inv(last["pose"])).astype(
            np.float32
        )

        # ---- commit object labels + build per-object meta (the
        # pose-dependent tail of DynObjTracking + Tracking.cc:1277-1528) ----
        t0 = _time.perf_counter()
        obj_label, oline_label, obj_meta = self._commit_objects(
            groups, obj_pulled, pose_np, pose_gt, gt_objs, last
        )
        self._oline_label = oline_label

        # update object point positions from optimized flows and collect
        # inlier masks
        obj_track_ok = np.zeros(self.NO, bool)
        oline_track_ok = np.zeros(self.NLO, bool)
        o_uv_np = np.array(o_uv)     # writable copies
        ol_uv_np = np.array(ol_uv)
        for om in obj_meta:
            if not om["stat"]:
                continue
            idx = om["pt_idx"]
            fl = om["flow"][: len(idx)]
            inl = om["pt_inlier"][: len(idx)]
            o_uv_np[idx[inl]] = (
                last["obj_uv"][idx[inl]] + fl[inl]
            )
            obj_track_ok[idx[inl]] = True
            lidx = om["ln_idx"]
            if len(lidx):
                lfl = om["ln_flow"][: len(lidx)]
                linl = om["ln_inlier"][: len(lidx)]
                ol_uv_np[lidx[linl]] = last["oline_uv"][lidx[linl]] + lfl[linl]
                oline_track_ok[lidx[linl]] = True
        timing[3] = (_time.perf_counter() - t0) * 1e3

        # ================= RENEW =================
        t0 = _time.perf_counter()
        if stat_tmp is None:   # legacy path: selections not yet run
            stat_tmp, line_tmp, oline_tmp = self._finish_selection(
                fin["det"], fin["point_detections"], fin["line_detections"],
                flow_np, h, w,
            )
        new_state = self._renew_frame_info(
            fin["depth_np"], fin["mask_np"],
            pose_np, flow_np, stat_tmp, line_tmp, obj_tmp, oline_tmp,
            s_uv, s_d, stat_track_ok,
            l_uv, l_d, line_track_ok,
            o_uv_np, o_d, o_sem, obj_label, obj_track_ok,
            ol_uv_np, ol_d, ol_sem, ol_v, oline_track_ok,
            pose_gt, gt_objs,
        )
        timing[4] = (_time.perf_counter() - t0) * 1e3

        # ================= MAP =================
        prev_pose_gt = last["pose_gt"]
        velocity_now = self.velocity
        self.last = new_state
        # association meta for the NEXT frame's grouping (must update in
        # the finish, not the deferrable map push -- DynObjTracking reads
        # it before the push would run)
        self.last_meta = {
            "sem_position": [om["sem"] for om in obj_meta],
            "mod_label": [om["label"] for om in obj_meta],
            "obj_stat": [om["stat"] for om in obj_meta],
            "obj_motion": {
                om["label"]: om["H"] for om in obj_meta if om["stat"]
            },
        }
        lba_fires = (
            cfg.run_local_ba
            and (f_id - cfg.overlap_size + 1)
            % max(cfg.window_size - cfg.overlap_size, 1) == 0
            and f_id >= cfg.window_size - 1
        )
        run_global_fires = (
            cfg.run_global_ba
            if cfg.run_global_ba is not None
            else cfg.choose_data == KITTI
        ) and f_id == stop_frame
        if cfg.run_local_ba and not lba_fires:
            # background-precompile the first window's fused program so
            # the first trigger doesn't pay the compile on the frame path
            from ..solvers import ba_builder as _bab
            _bab.maybe_precompile_partial_async(
                self.map, self.K, cfg, use_lines=cfg.use_lines,
                stop_frame=stop_frame,
            )
        if defer_push and not lba_fires and not run_global_fires:
            # the map push (incl. the world-3D recompute) runs after the
            # NEXT frame's dispatch, overlapping its device solve
            self._deferred_push = (
                new_state, pose_np, pose_gt, prev_pose_gt, velocity_now,
                obj_meta, timing,
            )
            return pose_np
        self._push_map(new_state, pose_np, pose_gt, prev_pose_gt,
                       velocity_now, obj_meta, timing)

        # ===== batch optimization triggers (Tracking.cc:1793-1884) =====
        from ..solvers import ba_builder

        if lba_fires:
            t0 = _time.perf_counter()
            ba_builder.partial_batch_optimization(
                self.map, self.K, cfg.window_size, cfg,
                use_lines=cfg.use_lines,
            )
            self.map.lba_times.append((_time.perf_counter() - t0) * 1e3)
            pose_np = np.linalg.inv(
                self.map.camera_poses[-1]
            ).astype(np.float32)
            self.last["pose"] = pose_np

        if run_global_fires:
            ba_builder.full_batch_optimization(
                self.map, self.K, cfg, use_lines=cfg.use_lines
            )
        return pose_np

    # ------------------------------------------------------------------
    def _group_objects(self, o_uv, o_d, o_sem, sf_valid, ol_uv, ol_sem,
                       ol_valid):
        """Mask-only half of DynObjTracking (Tracking.cc:2077-2523): group
        candidate object points by semantic label, reject
        boundary-dominated groups, and precompute the far/small flags plus
        the tentative tracking-label association (last-frame majority
        semantic label -> last motion model, Tracking.cc:2631-2699).  The
        pose-dependent scene-flow static test runs on device inside the
        fused step and is applied in :meth:`_commit_objects`."""
        cfg = self.cfg
        h, w = self.mask_np.shape
        last = self.last
        cand = sf_valid & (o_sem > 0)
        uniq = np.unique(o_sem[cand])
        uniq = uniq[uniq > 0]

        shr_c, shr_r = cfg.boundary_shrink_x, cfg.boundary_shrink_y
        if cfg.choose_data != KITTI:
            shr_c, shr_r = 0, 0

        last_sem = last["obj_sem"]
        groups = []
        for lab in uniq:
            pidx = np.nonzero(cand & (o_sem == lab))[0]
            lidx = np.nonzero(ol_valid & (ol_sem == lab))[0]
            if len(pidx) == 0:
                continue
            # boundary rejection (Tracking.cc:2460-2500)
            u, v = o_uv[pidx, 0], o_uv[pidx, 1]
            near = (
                (v < shr_r) | (v > h - shr_r) | (u < shr_c) | (u > w - shr_c)
            ).sum()
            if len(lidx):
                lu = ol_uv[lidx]
                near += (
                    (lu[:, 1] < shr_r) | (lu[:, 1] > h - shr_r)
                    | (lu[:, 0] < shr_c) | (lu[:, 0] > w - shr_c)
                    | (lu[:, 3] < shr_r) | (lu[:, 3] > h - shr_r)
                    | (lu[:, 2] < shr_c) | (lu[:, 2] > w - shr_c)
                ).sum()
            if near / max(len(pidx) + len(lidx), 1) > 0.5:
                continue
            # far / small flags (Tracking.cc:2575-2590); applied after the
            # static-test result arrives (static precedes far/small)
            far_small = (
                o_d[pidx].mean() > cfg.th_depth_obj
                or len(pidx) < cfg.min_object_points
            )
            # tentative association (committed in _commit_objects; new ids
            # are allocated only for objects that survive the static test)
            lb_last = last_sem[pidx]
            if len(lidx):
                lb_last = np.concatenate(
                    [lb_last, last["oline_sem"][lidx]]
                )
            vals, counts = np.unique(lb_last, return_counts=True)
            assoc_sem = int(vals[np.argmax(counts)])
            assigned = None
            if self.max_id > 1:
                for k, sem_pos in enumerate(self.last_meta["sem_position"]):
                    if (
                        sem_pos == assoc_sem
                        and self.last_meta["obj_stat"][k]
                    ):
                        assigned = self.last_meta["mod_label"][k]
                        break
            H_prev = (
                self.last_meta["obj_motion"].get(assigned)
                if assigned is not None else None
            )
            groups.append(dict(
                sem=int(lab), pidx=pidx, lidx=lidx, far_small=far_small,
                assigned=assigned, H_prev=H_prev,
            ))
        return groups[: self.MAXO]

    # ------------------------------------------------------------------
    def _build_buckets(self, groups, o_uv, o_d, ol_uv, sf_valid):
        """Pack the object groups into fixed (MB, P)/(MB, L) device buckets
        (MB = next power of two).  Returns None when there are no groups."""
        n_obj = len(groups)
        if n_obj == 0:
            return None
        last = self.last
        P, L = self.P_OBJ, self.L_OBJ
        # smallest power-of-two bucket (lane keys are folded by lane
        # index, so the RNG stream is identical for any MB -- including
        # the device-resident path's fixed MAXO lanes)
        MB = min(1 << max(n_obj - 1, 0).bit_length(), self.MAXO)
        b = dict(
            pt_obs=np.zeros((MB, P, 2), np.float32),
            pt_flow0=np.zeros((MB, P, 2), np.float32),
            pt_depth=np.ones((MB, P), np.float32),
            pt_cur_uv=np.zeros((MB, P, 2), np.float32),
            pt_cur_d=np.zeros((MB, P), np.float32),
            pt_valid=np.zeros((MB, P), bool),
            pt_sfvalid=np.zeros((MB, P), bool),
            ln_obs=np.zeros((MB, L, 4), np.float32),
            ln_flow0=np.zeros((MB, L, 4), np.float32),
            ln_depth=np.ones((MB, L, 2), np.float32),
            ln_valid=np.zeros((MB, L), bool),
            H_prev=np.tile(_EYE4, (MB, 1, 1)),
        )
        o_uv_np = np.asarray(o_uv)
        o_d_np = np.asarray(o_d)
        ol_uv_np = np.asarray(ol_uv)
        for k, g in enumerate(groups):
            pidx = g["pidx"][:P]
            lidx = g["lidx"][:L]
            n, m = len(pidx), len(lidx)
            # the edge unprojects LAST-frame pixels at last depths
            b["pt_obs"][k, :n] = last["obj_uv"][pidx]
            b["pt_depth"][k, :n] = last["obj_depth"][pidx]
            b["pt_flow0"][k, :n] = o_uv_np[pidx] - last["obj_uv"][pidx]
            b["pt_cur_uv"][k, :n] = o_uv_np[pidx]
            b["pt_cur_d"][k, :n] = o_d_np[pidx]
            b["pt_valid"][k, :n] = last["obj_depth"][pidx] > 0
            b["pt_sfvalid"][k, :n] = sf_valid[pidx]
            if m:
                b["ln_obs"][k, :m] = last["oline_uv"][lidx]
                b["ln_depth"][k, :m] = last["oline_depth"][lidx]
                b["ln_flow0"][k, :m] = (
                    ol_uv_np[lidx] - last["oline_uv"][lidx]
                )
                b["ln_valid"][k, :m] = (
                    last["oline_depth"][lidx].min(axis=1) > 0
                )
            if g["H_prev"] is not None:
                b["H_prev"][k] = g["H_prev"]
        b["any_lines"] = bool(b["ln_valid"].any())
        return b

    # ------------------------------------------------------------------
    def _dispatch_fused(self, key, velocity_np, T_lw_np, last, s_uv, s_d,
                        last_s_valid, l_use, buckets):
        """Pack the frame inputs into one flat f32 buffer, push it, and
        dispatch the fused frame chain (async); returns the flat tuple of
        device output arrays."""
        f32 = np.float32
        parts = [
            np.asarray(velocity_np, f32).ravel(),
            np.asarray(T_lw_np, f32).ravel(),
            last["stat_uv"].ravel(), last["stat_flow"].ravel(),
            last["stat_depth"],
            np.asarray(s_uv, f32).ravel(), np.asarray(s_d, f32),
            last_s_valid.astype(f32),
            last["line_uv"].ravel(), last["line_flow"].ravel(),
            last["line_depth"].ravel(), l_use.astype(f32),
        ]
        if buckets is not None:
            b = buckets
            parts += [
                b["pt_obs"].ravel(), b["pt_flow0"].ravel(),
                b["pt_depth"].ravel(), b["pt_cur_uv"].ravel(),
                b["pt_cur_d"].ravel(), b["pt_valid"].astype(f32).ravel(),
                b["pt_sfvalid"].astype(f32).ravel(),
                b["ln_obs"].ravel(), b["ln_flow0"].ravel(),
                b["ln_depth"].ravel(), b["ln_valid"].astype(f32).ravel(),
                b["H_prev"].ravel(),
            ]
        buf = jnp.asarray(np.concatenate(parts).astype(f32, copy=False))
        if buckets is None:
            return self._fused_cam_only(key, buf)
        return self._fused_track(
            key, buf, buckets["pt_obs"].shape[0], buckets["any_lines"]
        )

    def _dispatch_objects_legacy(self, key, pose_np, T_lw_np, buckets,
                                 n_obj):
        """Object chain for the non-fused (bJoint=false) path: init + joint
        solves, one dispatch + one pull."""
        if buckets is None:
            return None
        b = buckets
        keys = jax.random.split(
            jax.random.PRNGKey(1000 + self.f_id), b["pt_obs"].shape[0]
        )
        T_models = np.einsum("ij,njk->nik", pose_np, b["H_prev"]).astype(
            np.float32
        )
        results, init_inl, init_n = self._obj_init_solve(
            keys, jnp.asarray(T_models),
            jnp.asarray(np.linalg.inv(T_lw_np).astype(np.float32)),
            fs.PointBundle(
                obs=jnp.asarray(b["pt_obs"]),
                flow0=jnp.asarray(b["pt_flow0"]),
                depth=jnp.asarray(b["pt_depth"]),
                valid=jnp.asarray(b["pt_valid"]),
            ),
            fs.LineBundle(
                obs=jnp.asarray(b["ln_obs"]),
                flow0=jnp.asarray(b["ln_flow0"]),
                depth=jnp.asarray(b["ln_depth"]),
                valid=jnp.asarray(b["ln_valid"]),
            ),
            jnp.asarray(b["pt_cur_uv"]), jnp.asarray(b["pt_cur_d"]),
            b["any_lines"],
        )
        # host static test (scene flow with the already-known pose)
        Xp_w = _np_world_points(self.K, T_lw_np, b["pt_obs"], b["pt_depth"])
        Xc_w = _np_world_points(self.K, pose_np, b["pt_cur_uv"],
                                b["pt_cur_d"])
        f3 = Xc_w - Xp_w
        sfn = np.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
        v = b["pt_sfvalid"].astype(np.float32)
        nv = np.maximum(v.sum(axis=-1), 1.0)
        static_frac = (v * (sfn < self.cfg.sf_mg_thres)).sum(axis=-1) / nv
        o_G, o_flow, o_lflow, o_pinl, o_linl, init_n_np = jax.device_get(
            (results.pose[:n_obj], results.flow[:n_obj],
             results.line_flow[:n_obj], results.point_inlier[:n_obj],
             results.line_inlier[:n_obj], init_n[:n_obj])
        )
        return (o_G, o_flow, o_lflow, o_pinl, o_linl, init_n_np,
                static_frac[:n_obj])

    # ------------------------------------------------------------------
    def _commit_objects(self, groups, obj_pulled, pose_np, pose_gt,
                        gt_objs, last):
        """Apply the static test, commit tracking labels (allocating new
        ids for unassociated dynamic objects), and build the per-object
        meta consumed by renewal and the map (Tracking.cc:2528-2736 +
        :1277-1528)."""
        cfg = self.cfg
        obj_label = np.full(self.NO, -1, np.int32)
        oline_label = np.full(self.NLO, -1, np.int32)
        obj_meta = []
        if obj_pulled is None or not groups:
            return obj_label, oline_label, obj_meta
        (o_G, o_flow, o_lflow, o_pinl, o_linl, init_n_np,
         static_frac) = obj_pulled

        inv_pose = np.linalg.inv(pose_np)
        curr_twc_gt = np.linalg.inv(pose_gt)
        last_twc_gt = np.linalg.inv(last["pose_gt"])
        P, L = self.P_OBJ, self.L_OBJ

        for k, g in enumerate(groups):
            pidx, lidx = g["pidx"], g["lidx"]
            # static test (Tracking.cc:2528-2560): frac of x-z scene flow
            # below SFMgThres -> background label 0
            if float(static_frac[k]) > cfg.sf_ds_thres:
                obj_label[pidx] = 0
                oline_label[lidx] = 0
                continue
            # far / small rejection (Tracking.cc:2575-2590): label stays -1
            if g["far_small"]:
                continue
            assigned = g["assigned"]
            if assigned is None:
                assigned = self.max_id
                self.max_id += 1
            obj_label[pidx] = assigned
            oline_label[lidx] = assigned

            pidx_c, lidx_c = pidx[:P], lidx[:L]
            n = len(pidx_c)
            sem_lab = g["sem"]
            L_w_p = self._gt_obj_pose(last.get("gt_objs", []), sem_lab,
                                      last_twc_gt)
            L_w_c = self._gt_obj_pose(gt_objs, sem_lab, curr_twc_gt)
            stat = True
            H_gt_body = _EYE4.copy()
            pose_pre = _EYE4.copy()
            H_gt_world = _EYE4.copy()
            if L_w_p is None or L_w_c is None:
                stat = False           # Tracking.cc:1317-1334
            else:
                H_gt_body = (np.linalg.inv(L_w_p) @ L_w_c).astype(np.float32)
                H_gt_world = (L_w_c @ np.linalg.inv(L_w_p)).astype(np.float32)
                pose_pre = L_w_p
            if int(init_n_np[k]) < cfg.min_pnp_inliers_obj:
                stat = False           # init failure, Tracking.cc:1387-1399
            H = (inv_pose @ o_G[k]).astype(np.float32)
            if not stat:
                H = _EYE4.copy()
            centre = (
                _np_world_points(
                    self.K, last["pose"], last["obj_uv"][pidx_c],
                    last["obj_depth"][pidx_c],
                ).mean(axis=0)
                if n
                else np.zeros(3, np.float32)
            )
            # GT speed (Tracking.cc:1404-1409): v = t - (I-R) c, km/h x36
            sp_gt_v = H_gt_world[:3, 3] - (
                np.eye(3) - H_gt_world[:3, :3]
            ) @ centre[:3]
            speed_gt = float(np.linalg.norm(sp_gt_v)) * 36.0
            obj_meta.append(dict(
                label=assigned, sem=sem_lab, stat=stat, H=H,
                speed_gt=speed_gt, H_gt_body=H_gt_body, pose_pre=pose_pre,
                centre=centre, pt_idx=pidx_c, ln_idx=lidx_c,
                pt_inlier=o_pinl[k], ln_inlier=o_linl[k],
                flow=o_flow[k], ln_flow=o_lflow[k],
            ))
        return obj_label, oline_label, obj_meta

    def _gt_obj_pose(self, gt_rows, sem_label, twc_gt):
        """Find the GT pose row matching a semantic label; KITTI rows are in
        camera coords and lifted to world by Twc_gt (Tracking.cc:1289-1311)."""
        for row in gt_rows:
            if int(row[1]) == sem_label:
                if self.cfg.choose_data == OMD:
                    return obj_pose_parsing_ox(row, self.origin_inv)
                L = obj_pose_parsing_kt(row)
                return (twc_gt @ L).astype(np.float32)
        return None

    # ------------------------------------------------------------------
    def _renew_frame_info(self, depth_np, mask_np,
                          pose_np, flow_np, stat_tmp, line_tmp,
                          obj_tmp, oline_tmp,
                          s_uv, s_d, stat_ok, l_uv, l_d, line_ok,
                          o_uv, o_d, o_sem, obj_label, obj_ok,
                          ol_uv, ol_d, ol_sem, ol_valid, oline_ok,
                          pose_gt, gt_objs):
        """RenewFrameInfo (Tracking.cc:3959-4730): keep inliers, top-up from
        this frame's detections with dedup, recompute depth/3D, rebuild
        association ids.  ``depth_np``/``mask_np`` are the FRAME'S images,
        passed explicitly because in pipelined mode ``self.depth_np`` may
        already hold the next frame's data when this runs."""
        cfg = self.cfg
        h, w = mask_np.shape

        def filt_point(uv):
            x = uv[:, 0].astype(np.int32)
            y = uv[:, 1].astype(np.int32)
            inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
            xc, yc = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
            m = mask_np[yc, xc]
            d = depth_np[yc, xc]
            f = flow_np[yc, xc]
            corr = uv + f
            ok = (
                inb & (m == 0) & (d > 0) & (d <= 40.0)
                & (f[:, 0] != 0) & (f[:, 1] != 0)
                & (corr[:, 0] < w) & (corr[:, 0] > 0)
                & (corr[:, 1] < h) & (corr[:, 1] > 0)
            )
            return ok, d, f, corr

        # ---- static points: keep inliers ----
        keep_ok, kd, kf, kc = filt_point(s_uv)
        keep = stat_ok & keep_ok
        kept_idx = np.nonzero(keep)[0][: self.NS]

        new_uv = np.zeros((self.NS, 2), np.float32)
        new_d = np.zeros(self.NS, np.float32)
        new_f = np.zeros((self.NS, 2), np.float32)
        new_c = np.zeros((self.NS, 2), np.float32)
        new_asso = np.full(self.NS, -1, np.int32)
        nk = len(kept_idx)
        new_uv[:nk] = s_uv[kept_idx]
        new_d[:nk] = kd[kept_idx]
        new_f[:nk] = kf[kept_idx]
        new_c[:nk] = kc[kept_idx]
        new_asso[:nk] = kept_idx

        # ---- top-up from detections (strided order + 1px dedup against the
        # kept set, Tracking.cc:4091-4140) ----
        cs_uv, cs_d, cs_f, cs_c, cs_v = [np.asarray(a) for a in stat_tmp]
        if nk < self.NS:
            cand_ok, cd, cf, cc = filt_point(cs_uv)
            cand_ok &= cs_v
            if nk:
                cand_ok &= ~self._near_occupied(new_uv[:nk], cs_uv, h, w)
            order = self._strided_order(len(cs_uv), 10)
            pick = order[cand_ok[order]][: self.NS - nk]
            np_new = len(pick)
            new_uv[nk:nk + np_new] = cs_uv[pick]
            new_d[nk:nk + np_new] = cd[pick]
            new_f[nk:nk + np_new] = cf[pick]
            new_c[nk:nk + np_new] = cc[pick]
            nk += np_new
        stat_valid = np.arange(self.NS) < nk

        # ---- static lines: keep + top-up (Tracking.cc:4002-4261) ----
        new_l = np.zeros((self.NLS, 4), np.float32)
        new_ld = np.zeros((self.NLS, 2), np.float32)
        new_lf = np.zeros((self.NLS, 4), np.float32)
        new_lc = np.zeros((self.NLS, 4), np.float32)
        new_lasso = np.full(self.NLS, -1, np.int32)

        def filt_line(uv4):
            xs = uv4[:, 0].astype(np.int32); ys = uv4[:, 1].astype(np.int32)
            xe = uv4[:, 2].astype(np.int32); ye = uv4[:, 3].astype(np.int32)
            inb = (
                (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
                & (xe > 0) & (xe < w - 1) & (ye > 0) & (ye < h - 1)
            )
            xsc, ysc = np.clip(xs, 0, w - 1), np.clip(ys, 0, h - 1)
            xec, yec = np.clip(xe, 0, w - 1), np.clip(ye, 0, h - 1)
            ms = mask_np[ysc, xsc]; me = mask_np[yec, xec]
            ds = depth_np[ysc, xsc]; de = depth_np[yec, xec]
            xm = ((xs + xe) // 2).clip(0, w - 1)
            ym = ((ys + ye) // 2).clip(0, h - 1)
            dm = depth_np[ym, xm]
            ln = np.sqrt((xs - xe) ** 2 + (ys - ye) ** 2).astype(np.float32)
            disc = np.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
            fs_ = flow_np[ysc, xsc]; fe_ = flow_np[yec, xec]
            f4 = np.concatenate([fs_, fe_], axis=1)
            corr = uv4 + f4
            degen = (np.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6) & (
                np.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6
            )
            ok = (
                inb & ~degen & (ms == 0) & (me == 0)
                & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0)
                & disc
                & (corr[:, 0] > 0) & (corr[:, 0] < w)
                & (corr[:, 1] > 0) & (corr[:, 1] < h)
                & (corr[:, 2] > 0) & (corr[:, 2] < w)
                & (corr[:, 3] > 0) & (corr[:, 3] < h)
            )
            d2 = np.stack([ds, de], axis=1)
            return ok, d2, f4, corr

        lk_ok, lkd, lkf, lkc = filt_line(l_uv)
        lkeep = line_ok & lk_ok
        lkept = np.nonzero(lkeep)[0][: self.NLS]
        nlk = len(lkept)
        new_l[:nlk] = l_uv[lkept]
        new_ld[:nlk] = lkd[lkept]
        new_lf[:nlk] = lkf[lkept]
        new_lc[:nlk] = lkc[lkept]
        new_lasso[:nlk] = lkept

        cl_uv, cl_d, cl_f, cl_c, cl_v = [np.asarray(a) for a in line_tmp]
        if nlk < self.NLS and cl_v.any():
            cok, cld, clf, clc = filt_line(cl_uv)
            cok &= cl_v
            if nlk:
                cok &= ~self._line_dup(cl_uv, new_l[:nlk])
            pick = np.nonzero(cok)[0][: self.NLS - nlk]
            nn = len(pick)
            new_l[nlk:nlk + nn] = cl_uv[pick]
            new_ld[nlk:nlk + nn] = cld[pick]
            new_lf[nlk:nlk + nn] = clf[pick]
            new_lc[nlk:nlk + nn] = clc[pick]
            nlk += nn
        line_valid = np.arange(self.NLS) < nlk

        # ---- objects: keep inliers per object, top-up to cap per object,
        # add new-label candidates (Tracking.cc:4381-4692) ----
        co_uv, co_d, co_f, co_c, co_s, co_v = [np.asarray(a) for a in obj_tmp]
        no_uv = np.zeros((self.NO, 2), np.float32)
        no_d = np.zeros(self.NO, np.float32)
        no_f = np.zeros((self.NO, 2), np.float32)
        no_c = np.zeros((self.NO, 2), np.float32)
        no_sem = np.zeros(self.NO, np.int32)
        no_label = np.full(self.NO, -2, np.int32)
        no_asso = np.full(self.NO, -1, np.int32)
        cursor = 0

        def obj_filt(uv):
            x = uv[:, 0].astype(np.int32); y = uv[:, 1].astype(np.int32)
            inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
            xc, yc = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
            m = mask_np[yc, xc]
            d = depth_np[yc, xc]
            f = flow_np[yc, xc]
            corr = uv + f
            ok = (
                inb & (m != 0) & (d > 0) & (d < cfg.th_depth_obj)
                & (corr[:, 0] < w) & (corr[:, 0] > 0)
                & (corr[:, 1] < h) & (corr[:, 1] > 0)
            )
            return ok, m, d, f, corr

        ok_o, m_o, d_o, f_o, c_o = obj_filt(o_uv)
        tracked_labels = [int(x) for x in np.unique(obj_label) if x > 0]
        live_sems = set()
        label_sem = {}
        for lab in tracked_labels:
            idx = np.nonzero((obj_label == lab) & obj_ok & ok_o)[0]
            sem_now = (
                int(np.bincount(m_o[idx]).argmax()) if len(idx) else 0
            )
            live_sems.add(sem_now)
            label_sem[lab] = sem_now
            take = idx[: self.P_OBJ]
            n = len(take)
            if cursor + n > self.NO:
                n = self.NO - cursor
                take = take[:n]
            no_uv[cursor:cursor + n] = o_uv[take]
            no_d[cursor:cursor + n] = d_o[take]
            no_f[cursor:cursor + n] = f_o[take]
            no_c[cursor:cursor + n] = c_o[take]
            no_sem[cursor:cursor + n] = m_o[take]
            no_label[cursor:cursor + n] = lab
            no_asso[cursor:cursor + n] = take
            cursor += n
            # top-up from this frame's stride-4 candidates on the same mask
            # label (Tracking.cc:4468-4562)
            if n < self.P_OBJ and co_v.any():
                cok, cm, cdd, cff, ccc = obj_filt(co_uv)
                cok &= co_v & (cm == sem_now) & (sem_now != 0)
                if n:
                    cok &= ~self._near_occupied(o_uv[take], co_uv, h, w)
                pick = np.nonzero(cok)[0][: self.P_OBJ - n]
                nn = min(len(pick), self.NO - cursor)
                pick = pick[:nn]
                no_uv[cursor:cursor + nn] = co_uv[pick]
                no_d[cursor:cursor + nn] = cdd[pick]
                no_f[cursor:cursor + nn] = cff[pick]
                no_c[cursor:cursor + nn] = ccc[pick]
                no_sem[cursor:cursor + nn] = cm[pick]
                no_label[cursor:cursor + nn] = lab
                cursor += nn

        # new semantic labels not currently tracked enter as fresh
        # candidates (next frame's DynObjTracking will classify them,
        # Tracking.cc:4627-4692)
        if co_v.any() and cursor < self.NO:
            cok, cm, cdd, cff, ccc = obj_filt(co_uv)
            cok &= co_v
            for sem_new in [int(x) for x in np.unique(cm[cok]) if x != 0]:
                if sem_new in live_sems:
                    continue
                pick = np.nonzero(cok & (cm == sem_new))[0][: self.P_OBJ]
                nn = min(len(pick), self.NO - cursor)
                pick = pick[:nn]
                no_uv[cursor:cursor + nn] = co_uv[pick]
                no_d[cursor:cursor + nn] = cdd[pick]
                no_f[cursor:cursor + nn] = cff[pick]
                no_c[cursor:cursor + nn] = ccc[pick]
                no_sem[cursor:cursor + nn] = cm[pick]
                no_label[cursor:cursor + nn] = -2
                cursor += nn
        obj_valid = np.arange(self.NO) < cursor

        # ---- object lines: keep + top-up per object ----
        nol_uv = np.zeros((self.NLO, 4), np.float32)
        nol_d = np.zeros((self.NLO, 2), np.float32)
        nol_f = np.zeros((self.NLO, 4), np.float32)
        nol_c = np.zeros((self.NLO, 4), np.float32)
        nol_sem = np.zeros(self.NLO, np.int32)
        nol_label = np.full(self.NLO, -2, np.int32)
        nol_asso = np.full(self.NLO, -1, np.int32)
        lcursor = 0
        col_uv, col_d, col_f, col_c, col_s, col_v = [
            np.asarray(a) for a in oline_tmp
        ]
        oline_label_arr = getattr(
            self, "_oline_label", np.full(self.NLO, -2, np.int32)
        )
        def _obj_line_dup(cand_uv4, kept_uv4):
            """Reference object-line dedup gate (Tracking.cc:4584-4602):
            angle difference < 1 rad AND midpoint distance < 1 px."""
            if not len(kept_uv4):
                return np.zeros(len(cand_uv4), bool)
            a1 = np.arctan2(cand_uv4[:, 3] - cand_uv4[:, 1],
                            cand_uv4[:, 2] - cand_uv4[:, 0])
            a2 = np.arctan2(kept_uv4[:, 3] - kept_uv4[:, 1],
                            kept_uv4[:, 2] - kept_uv4[:, 0])
            ad = np.abs(a1[:, None] - a2[None, :])
            ad = np.where(ad > np.pi, 2 * np.pi - ad, ad)
            m1 = 0.5 * (cand_uv4[:, :2] + cand_uv4[:, 2:])
            m2 = 0.5 * (kept_uv4[:, :2] + kept_uv4[:, 2:])
            md = np.linalg.norm(m1[:, None] - m2[None], axis=2)
            return ((ad < 1.0) & (md < 1.0)).any(axis=1)

        col_ok_all, _, _, _ = (
            filt_line(col_uv) if col_v.any()
            else (np.zeros(len(col_uv), bool), None, None, None)
        )
        for lab in tracked_labels:
            lidx = np.nonzero(
                (oline_label_arr == lab) & oline_ok & ol_valid
            )[0][: self.L_OBJ]
            n = min(len(lidx), self.NLO - lcursor)
            lidx = lidx[:n]
            kept_start = lcursor
            nol_uv[lcursor:lcursor + n] = ol_uv[lidx]
            nol_d[lcursor:lcursor + n] = ol_d[lidx]
            nol_sem[lcursor:lcursor + n] = ol_sem[lidx]
            nol_label[lcursor:lcursor + n] = lab
            nol_asso[lcursor:lcursor + n] = lidx
            lcursor += n
            # top-up to the per-object cap from this frame's detections on
            # the SAME semantic label, under this object's tracking label
            # (Tracking.cc:4562-4608, max_num_obj_line = 100/object)
            sem_now = label_sem.get(lab, 0)
            if n < self.L_OBJ and sem_now != 0 and col_v.any():
                cok = col_v & col_ok_all & (col_s == sem_now)
                cok &= ~_obj_line_dup(col_uv, nol_uv[kept_start:lcursor])
                pick = np.nonzero(cok)[0][: self.L_OBJ - n]
                nn = min(len(pick), self.NLO - lcursor)
                pick = pick[:nn]
                nol_uv[lcursor:lcursor + nn] = col_uv[pick]
                nol_d[lcursor:lcursor + nn] = col_d[pick]
                nol_f[lcursor:lcursor + nn] = col_f[pick]
                nol_c[lcursor:lcursor + nn] = col_c[pick]
                nol_sem[lcursor:lcursor + nn] = col_s[pick]
                nol_label[lcursor:lcursor + nn] = lab
                lcursor += nn
        # lines of NEW semantic labels enter with label -2 alongside the
        # new-object points (Tracking.cc:4668-4684)
        if col_v.any() and lcursor < self.NLO:
            for sem_new in [int(x) for x in np.unique(col_s[col_v])
                            if x != 0]:
                if sem_new in live_sems:
                    continue
                pick = np.nonzero(col_v & (col_s == sem_new))[0]
                nn = min(len(pick), self.NLO - lcursor)
                pick = pick[:nn]
                nol_uv[lcursor:lcursor + nn] = col_uv[pick]
                nol_d[lcursor:lcursor + nn] = col_d[pick]
                nol_f[lcursor:lcursor + nn] = col_f[pick]
                nol_c[lcursor:lcursor + nn] = col_c[pick]
                nol_sem[lcursor:lcursor + nn] = col_s[pick]
                nol_label[lcursor:lcursor + nn] = -2
                lcursor += nn
        oline_valid = np.arange(self.NLO) < lcursor
        # recompute flows/corres for kept object lines at their new positions
        lok, _, _, _ = filt_line(nol_uv)
        lf_s = flow_np[
            np.clip(nol_uv[:, 1].astype(np.int32), 0, h - 1),
            np.clip(nol_uv[:, 0].astype(np.int32), 0, w - 1),
        ]
        lf_e = flow_np[
            np.clip(nol_uv[:, 3].astype(np.int32), 0, h - 1),
            np.clip(nol_uv[:, 2].astype(np.int32), 0, w - 1),
        ]
        nol_f = np.concatenate([lf_s, lf_e], axis=1).astype(np.float32)
        nol_c = nol_uv + nol_f

        # world-3D recompute happens in _push_map (nothing on the joint
        # tracking path reads it; doing it after the NEXT dispatch takes
        # it off the renewal -> dispatch critical path)
        return dict(
            pose=pose_np, pose_gt=pose_gt,
            stat_uv=new_uv, stat_depth=new_d, stat_flow=new_f,
            stat_corres=new_c, stat_valid=stat_valid,
            stat_asso=new_asso,
            line_uv=new_l, line_depth=new_ld, line_flow=new_lf,
            line_corres=new_lc, line_valid=line_valid,
            line_asso=new_lasso,
            obj_uv=no_uv, obj_depth=no_d, obj_flow=no_f, obj_corres=no_c,
            obj_sem=no_sem, obj_valid=obj_valid,
            obj_label=no_label, obj_asso=no_asso,
            oline_uv=nol_uv, oline_depth=nol_d, oline_flow=nol_f,
            oline_corres=nol_c, oline_sem=nol_sem, oline_valid=oline_valid,
            oline_label=nol_label, oline_asso=nol_asso,
            gt_objs=gt_objs,
        )

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def _strided_order_cached(n: int, step: int):
        order = []
        for start in range(step):
            order.extend(range(start, n, step))
        return np.asarray(order, np.int64)

    def _strided_order(self, n, step):
        return self._strided_order_cached(n, step)

    @staticmethod
    def _near_occupied(kept_uv, cand_uv, h, w):
        """O(N) 1px-radius dedup (replaces the reference's O(N^2) scan,
        Tracking.cc:4105-4123): occupancy bitmap of kept positions dilated
        by one pixel, candidates tested by lookup."""
        occ = np.zeros((h + 2, w + 2), bool)
        kx = np.clip(kept_uv[:, 0].astype(np.int32), 0, w - 1)
        ky = np.clip(kept_uv[:, 1].astype(np.int32), 0, h - 1)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                occ[ky + dy, kx + dx] = True
        cx = np.clip(cand_uv[:, 0].astype(np.int32), 0, w - 1)
        cy = np.clip(cand_uv[:, 1].astype(np.int32), 0, h - 1)
        return occ[cy + 1, cx + 1]

    @staticmethod
    def _line_dup(cand_uv4, kept_uv4):
        """Reference line dedup (Tracking.cc:4174-4203 / Frame.cc:1582):
        near-parallel (angle < pi/30) and midpoint distance < max(len)/2."""
        c_dir = cand_uv4[:, 2:] - cand_uv4[:, :2]
        k_dir = kept_uv4[:, 2:] - kept_uv4[:, :2]
        c_mid = 0.5 * (cand_uv4[:, 2:] + cand_uv4[:, :2])
        k_mid = 0.5 * (kept_uv4[:, 2:] + kept_uv4[:, :2])
        c_len = np.linalg.norm(c_dir, axis=1) + 1e-9
        k_len = np.linalg.norm(k_dir, axis=1) + 1e-9
        cosang = (
            c_dir @ k_dir.T / (c_len[:, None] * k_len[None, :])
        )
        # |a-b|^2 = |a|^2 + |b|^2 - 2 a.b  (no (C,K,2) intermediate)
        middist2 = (
            np.sum(c_mid * c_mid, 1)[:, None]
            + np.sum(k_mid * k_mid, 1)[None, :]
            - 2.0 * (c_mid @ k_mid.T)
        )
        r = 0.5 * np.maximum(c_len[:, None], k_len[None, :])
        dup = (cosang > np.cos(np.pi / 30)) & (middist2 < r * r)
        return dup.any(axis=1)

    # ------------------------------------------------------------------
    def _push_map(self, st, pose_np, pose_gt, prev_pose_gt, velocity,
                  obj_meta, timing):
        """Map appends (Tracking.cc:1578-1786).  Pure with respect to
        tracker state (only the map mutates): ``prev_pose_gt`` and
        ``velocity`` are passed explicitly because in deferred mode this
        runs after the NEXT frame has already updated self.last/velocity."""
        m = self.map
        if "stat_3d" not in st:
            st["stat_3d"] = _np_world_points(
                self.K, pose_np, st["stat_uv"], st["stat_depth"]
            )
            st["line_3d"] = _np_world_lines(
                self.K, pose_np, st["line_uv"], st["line_depth"]
            )
            st["obj_3d"] = _np_world_points(
                self.K, pose_np, st["obj_uv"], st["obj_depth"]
            )
            st["oline_3d"] = _np_world_lines(
                self.K, pose_np, st["oline_uv"], st["oline_depth"]
            )
        m.stat_uv.append(st["stat_uv"]); m.stat_depth.append(st["stat_depth"])
        m.stat_3d.append(st["stat_3d"]); m.stat_valid.append(st["stat_valid"])
        m.stat_asso.append(st["stat_asso"])
        m.line_uv.append(st["line_uv"]); m.line_depth.append(st["line_depth"])
        m.line_3d.append(st["line_3d"]); m.line_valid.append(st["line_valid"])
        m.line_asso.append(st["line_asso"])
        m.line_plucker.append(_np_plucker(st["line_3d"][:, :3], st["line_3d"][:, 3:]))
        m.dyn_uv.append(st["obj_uv"]); m.dyn_depth.append(st["obj_depth"])
        m.dyn_3d.append(st["obj_3d"]); m.dyn_valid.append(st["obj_valid"])
        m.dyn_asso.append(st["obj_asso"]); m.dyn_label.append(st["obj_label"])
        m.dline_uv.append(st["oline_uv"]); m.dline_depth.append(st["oline_depth"])
        m.dline_3d.append(st["oline_3d"]); m.dline_valid.append(st["oline_valid"])
        m.dline_asso.append(st["oline_asso"]); m.dline_label.append(st["oline_label"])
        m.dline_plucker.append(_np_plucker(st["oline_3d"][:, :3], st["oline_3d"][:, 3:]))

        m.camera_poses.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_rf.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_gt.append(np.linalg.inv(pose_gt).astype(np.float32))

        cam_motion = np.linalg.inv(velocity).astype(np.float32)
        motions = [cam_motion]
        pose_pres = [cam_motion]
        labels = [0]
        sems = [0]
        stats = [True]
        centres = [np.zeros(3, np.float32)]
        motions_gt = [
            (prev_pose_gt @ np.linalg.inv(pose_gt)).astype(np.float32)
        ]
        speeds = [1.0]
        for om in obj_meta:
            if not om["stat"]:
                continue
            motions.append(om["H"])
            pose_pres.append(om["pose_pre"])
            labels.append(om["label"])
            sems.append(om["sem"])
            stats.append(True)
            centres.append(om["centre"])
            motions_gt.append(om["H_gt_body"])
            speeds.append(om["speed_gt"])
        m.rigid_motions.append(motions)
        m.rigid_motions_rf.append([x.copy() for x in motions])
        m.rigid_motions_gt.append(motions_gt)
        m.obj_pose_pre.append(pose_pres)
        m.rigid_centres.append(centres)
        m.rm_labels.append(labels)
        m.sm_labels.append(sems)
        m.obj_stat.append(stats)
        m.speeds_gt.append(speeds)
        m.frame_times.append(timing.copy())
