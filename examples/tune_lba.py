"""Solver-budget sweep for the PARTIAL (window) BA on the GPU.

Each LM iteration of the warm fused window costs a fixed part plus a
per-CG-iteration part (examples/measure_lba_budget.py splits them), so
(LM iterations x CG budget) is the whole warm-window wall.  The reference's own budget is optimize(100)
with a gain-1e-3 terminate action (Optimizer.cc:2462,1410) — which burns
19-21 LM iterations here.  This sweep measures what a smaller budget
actually costs in TRAJECTORY terms, the same methodology as
examples/tune_chained.py (round 4's lm_rel_tol change): a candidate is
adoptable only if its trajectory delta vs the reference budget sits well
under the f32 solver noise floor that the parity gates bound
(~0.02-0.03 deg / sub-mm — tests/test_chained_kitti.py).

Runs the EXACT bench configuration (KITTI caps, 2 objects, detectors in
loop, LBA at reference cadence, 53 tracked frames -> windows at frames
19/35/51).  Per combo: median non-LBA frame wall, every window's wall,
RPE vs GT, and RPE-style delta vs the reference-budget trajectory.

Run on the GPU:  python examples/tune_lba.py [n]
Prints one JSON line per combo.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))

# (ba_local_iterations cap, ba_local_cg_iters, ba_gain_threshold_partial)
# first entry = the production reference-parity budget.
# Override with SDPL_TUNE_GRID="iters,cg,gain[;iters,cg,gain...]".
GRID = [
    (100, 40, 1e-3),
    (100, 10, 1e-3),
    (12, 10, 1e-3),
    (8, 10, 1e-3),
    (100, 10, 3e-3),
]
import os as _os  # noqa: E402
if _os.environ.get("SDPL_TUNE_GRID"):
    GRID = [
        (int(a), int(b), float(c))
        for a, b, c in (
            combo.split(",")
            for combo in _os.environ["SDPL_TUNE_GRID"].split(";")
        )
    ]


def _rpe_vs(poses_a, poses_b):
    """Median per-frame relative-pose delta (t in m, r in deg), f64."""
    ts, rs = [], []
    for f in range(1, len(poses_a)):
        a0, a1 = (np.asarray(p, np.float64) for p in
                  (poses_a[f - 1], poses_a[f]))
        b0, b1 = (np.asarray(p, np.float64) for p in
                  (poses_b[f - 1], poses_b[f]))
        d = (np.linalg.inv(np.linalg.inv(a0) @ a1)
             @ (np.linalg.inv(b0) @ b1))
        ts.append(np.linalg.norm(d[:3, 3]))
        rs.append(np.degrees(np.arccos(np.clip(
            (np.trace(d[:3, :3]) - 1) / 2, -1, 1))))
    return float(np.median(ts)), float(np.median(rs))


def main():
    import jax

    from synthetic import SynthConfig, SynthSequence, synth_settings
    from sdpl_slam_tpu.models.system import System
    from sdpl_slam_tpu.utils import metrics

    plat = jax.devices()[0].platform
    print("# backend:", plat, file=sys.stderr)

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 54
    cfg = SynthConfig(
        n_frames=n_frames, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=0.2,
    )
    seq = SynthSequence(cfg)
    n = seq.n_frames - 1
    warmup = 4

    ref_poses = None
    for iters, cg, gain in GRID:
        settings = synth_settings(cfg)
        settings.fx, settings.fy = cfg.fx, cfg.fy
        settings.cx, settings.cy = cfg.cx, cfg.cy
        settings.width, settings.height = cfg.width, cfg.height
        settings.max_track_point_bg = 1200
        settings.max_track_point_obj = 800
        settings.max_static_lines = 400
        settings.max_objects = 8
        settings.th_depth_bg = 40.0
        settings.th_depth_obj = 25.0
        settings.min_object_points = 150
        settings.use_sample_fea = 0
        settings.chained_tracking = plat != "cpu"
        settings.run_local_ba = True
        settings.window_size, settings.overlap_size = 20, 4
        settings.ba_local_iterations = iters
        settings.ba_local_cg_iters = cg
        settings.ba_gain_threshold_partial = gain

        system = System(settings, verbose=False)
        times = []
        for t in range(n):
            f = seq.frame(t)
            nxt = seq.frame(t + 1) if t + 1 < n else None
            nxt2 = seq.frame(t + 2) if t + 2 < n else None
            t0 = time.perf_counter()
            system.track_rgbd(
                f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                t * 0.1, n + 1,
                next_image=None if nxt is None else nxt.gray,
                next_image2=None if nxt2 is None else nxt2.gray,
            )
            if t >= warmup:
                times.append(time.perf_counter() - t0)
        system.tracker.flush()

        stride = settings.window_size - settings.overlap_size
        lba_frames = {
            f + 1 for f in range(n)
            if f >= settings.window_size - 1
            and (f - settings.overlap_size + 1) % stride == 0
        }
        track = [dt for t, dt in enumerate(times, start=warmup)
                 if t not in lba_frames]
        med_ms = float(np.median(track)) * 1e3

        t_err, r_err = metrics.camera_rpe(
            system.map.camera_poses, system.map.camera_poses_gt
        )
        poses = [np.asarray(p) for p in system.map.camera_poses]
        if ref_poses is None:
            ref_poses = poses
            dt_ref, dr_ref = 0.0, 0.0
        else:
            dt_ref, dr_ref = _rpe_vs(poses, ref_poses)

        lbas = [round(float(x), 1) for x in system.map.lba_times]
        warm = min(lbas) if lbas else None
        # steady-state LBA-inclusive throughput: one warm window per
        # `stride` tracked frames
        if warm is not None:
            lba_fps = round(
                stride / (stride * med_ms / 1e3 + warm / 1e3), 3
            )
        else:
            lba_fps = None
        print(json.dumps({
            "ba_local_iterations": iters,
            "ba_local_cg_iters": cg,
            "gain_partial": gain,
            "median_frame_ms": round(med_ms, 1),
            "lba_window_ms": lbas,
            "lba_warm_ms": warm,
            "rpe_t_m": round(float(t_err), 6),
            "rpe_r_deg": round(float(r_err), 5),
            "dt_vs_ref_m": round(dt_ref, 7),
            "dr_vs_ref_deg": round(dr_ref, 6),
            "tracking_plus_lba_fps_est": lba_fps,
        }), flush=True)


if __name__ == "__main__":
    main()
