"""ba_schur decision measurement on the GPU.

Times the two fused local-BA step engines at the real 20-frame KITTI
window (reference cadence, /root/reference/src/Optimizer.cc:1235,2462):

 * CG:    batch_ba.run_ba_fused   (matrix-free block-Jacobi PCG steps)
 * Schur: schur_ba.run_ba_fused_schur (exact dense-Schur direct steps —
          the g2o BlockSolver elimination, block_solver.hpp)

Run on the GPU:  python examples/measure_ba_schur.py
Prints one JSON line: warm per-call wall, iterations taken, final cost
for each engine — the numbers that decide `ba_schur`'s default
(utils/config.py:180).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    from synthetic import SynthConfig, SynthSequence, synth_settings
    from sdpl_slam_tpu.models.system import System
    from sdpl_slam_tpu.solvers import ba_builder

    import jax
    plat = jax.devices()[0].platform
    print("# backend:", plat, file=sys.stderr)

    # KITTI-scale tracked map covering one full window
    cfg = SynthConfig(
        n_frames=22, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=0.2,
    )
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.run_local_ba = False      # BA driven manually below
    settings.chained_tracking = plat != "cpu"
    sys_ = System(settings, verbose=False)
    n = 21
    for t in range(n):
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if t + 1 < n else None
        sys_.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,
            next_image=None if nxt is None else nxt.gray,
        )
    sys_.tracker.flush()
    m = sys_.map
    K = sys_.tracker.K

    import copy

    out = {"metric": "lba_window20_engine_ms", "backend": plat}
    # cg_mixed: f64 CG recurrences over f32 storage (ba_dtype="mixed") —
    # measures what the conditioning insurance costs on this backend
    # (the f64 work is O(dof) vector updates only)
    for engine, flag, dtype in (("cg", False, "float32"),
                                ("schur", True, "float32"),
                                ("cg_mixed", False, "mixed")):
        settings.ba_schur = flag
        settings.ba_dtype = dtype
        store = {}      # one ratchet per engine: rep 0 compiles, 1+ warm
        times = []
        for rep in range(4):
            mm = copy.deepcopy(m)
            mm._ba_bucket_ratchet = store
            t0 = time.perf_counter()
            cost = ba_builder.partial_batch_optimization(
                mm, K, settings.window_size, settings,
                use_lines=settings.use_lines,
            )
            times.append((time.perf_counter() - t0) * 1e3)
        out[engine + "_compile_ms"] = round(times[0], 1)
        out[engine + "_warm_ms"] = round(float(np.median(times[1:])), 1)
        out[engine + "_cost"] = float(cost)
        print("# %s: compile %.0f ms, warm %s ms, cost %.4f"
              % (engine, times[0],
                 [round(x) for x in times[1:]], cost), file=sys.stderr)

    ratio = out["schur_warm_ms"] / max(out["cg_warm_ms"], 1e-9)
    out["schur_over_cg"] = round(ratio, 3)
    out["recommend_schur_default"] = bool(ratio < 1.0)
    out["mixed_over_cg"] = round(
        out["cg_mixed_warm_ms"] / max(out["cg_warm_ms"], 1e-9), 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
