"""LM-budget sweep for the chained frame step on the GPU (the LM
iteration budget and exit tolerance of the fused step).

For each (lm_rel_tol, lm_iterations) combo this tracks the bench
configuration (KITTI caps, 2 objects, detectors in loop, LBA OFF to
isolate the frame step) and reports the median frame wall plus accuracy
against ground truth AND against the reference combo's trajectory, so a
faster setting can be adopted only if it stays inside the parity bar.

Run on the GPU:  python examples/tune_chained.py [n]
Prints one JSON line per combo.  Each combo compiles its own program set
(the tolerances are trace constants), so the sweep is deliberately
small.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))

# (lm_rel_tol, lm_iterations); the first entry is the production default
GRID = [
    (1e-5, 100),
    (1e-4, 100),
    (1e-4, 50),
    (3e-4, 30),
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

    plat = jax.devices()[0].platform
    print("# backend:", plat, file=sys.stderr)

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    if os.environ.get("SDPL_TUNE_SMALL"):
        # CPU smoke mode: tiny frames, default caps (script logic check)
        cfg = SynthConfig(n_frames=n + 2, n_objects=1, noise_flow=0.2)
    else:
        cfg = SynthConfig(
            n_frames=n + 2, n_objects=2, width=1242, height=375,
            fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
            noise_flow=0.2,
        )
    seq = SynthSequence(cfg)
    small = bool(os.environ.get("SDPL_TUNE_SMALL"))

    ref_poses = None
    for rel_tol, iters in GRID:
        settings = synth_settings(cfg)
        if not small:
            settings.max_track_point_bg = 1200
            settings.max_track_point_obj = 800
            settings.max_static_lines = 400
            settings.max_objects = 8
            settings.th_depth_bg, settings.th_depth_obj = 40.0, 25.0
            settings.min_object_points = 150
            settings.use_sample_fea = 0
        settings.run_local_ba = False
        settings.chained_tracking = plat != "cpu"
        settings.lm_rel_tol = rel_tol
        settings.lm_iterations = iters

        system = System(settings, verbose=False)
        times = []
        for t in range(n):
            f = seq.frame(t)
            nxt = seq.frame(t + 1)
            nxt2 = seq.frame(t + 2)
            t0 = time.perf_counter()
            system.track_rgbd(
                f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                t * 0.1, n + 1,
                next_image=nxt.gray, next_image2=nxt2.gray,
            )
            if t >= 4:
                times.append(time.perf_counter() - t0)
        system.tracker.flush()

        from sdpl_slam_tpu.utils import metrics
        t_err, r_err = metrics.camera_rpe(
            system.map.camera_poses, system.map.camera_poses_gt
        )
        poses = [np.asarray(p) for p in system.map.camera_poses]
        if ref_poses is None:
            ref_poses = poses
            dt, dr = 0.0, 0.0
        else:
            dt, dr = _rpe_vs(ref_poses, poses)
        print(json.dumps({
            "lm_rel_tol": rel_tol, "lm_iterations": iters,
            "median_frame_ms": round(float(np.median(times)) * 1e3, 1),
            "rpe_t_m": round(float(t_err), 6),
            "rpe_r_deg": round(float(r_err), 5),
            "delta_vs_default_t_m": round(dt, 6),
            "delta_vs_default_r_deg": round(dr, 5),
        }), flush=True)


if __name__ == "__main__":
    main()
