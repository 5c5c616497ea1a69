"""LBA cost-split probe on the GPU: linearize vs CG, and cg_iters sweep.

Builds the real bench-config window graph (20 tracked KITTI-scale
frames) and times the fused solve at various (max_iters, cg_iters),
plus a hacked cg_iters=0-equivalent to isolate linearize cost.

    python examples/measure_lba_budget.py
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))

from synthetic import SynthConfig, SynthSequence, synth_settings  # noqa

from sdpl_slam_tpu.models.system import System  # noqa
from sdpl_slam_tpu.solvers import ba_builder, batch_ba as bb  # noqa


def main():
    import jax

    plat = jax.devices()[0].platform
    print("# backend:", plat, file=sys.stderr)

    cfg = SynthConfig(
        n_frames=22, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=0.2,
    )
    seq = SynthSequence(cfg)
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
    settings.run_local_ba = False
    settings.chained_tracking = plat != "cpu"
    system = System(settings, verbose=False)
    n = 21
    for t in range(n):
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if t + 1 < n else None
        nxt2 = seq.frame(t + 2) if t + 2 < n else None
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,
            next_image=None if nxt is None else nxt.gray,
            next_image2=None if nxt2 is None else nxt2.gray,
        )
    system.tracker.flush()
    m = system.map

    graph, _ = ba_builder.build_graph(
        m, system.tracker.K, 0, 20, min_track_len=3,
        motion_init_identity=False, prior_info=1e7,
    )
    n_edges = sum(int(np.asarray(v).sum()) for v in (
        graph.sp_valid, graph.dp_valid, graph.tern_valid,
        graph.odo_valid, graph.smo_valid,
    ))
    print("# graph edges (valid):", n_edges, file=sys.stderr)
    w = bb.BAWeights()

    def timed(label, fn, reps=3):
        fn()                      # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out[0] if isinstance(out, tuple)
                                  else out)
            ts.append((time.perf_counter() - t0) * 1e3)
        print("%-34s %8.1f ms  (reps %s)"
              % (label, float(np.median(ts)),
                 [round(x) for x in ts]), flush=True)
        return float(np.median(ts))

    for mi, ci in ((1, 1), (1, 10), (1, 40), (4, 40), (34, 40),
                   (34, 10), (34, 20)):
        timed("fused max_iters=%d cg_iters=%d" % (mi, ci),
              lambda mi=mi, ci=ci: bb.run_ba_fused(
                  graph, w, max_iters=mi, cg_iters=ci,
                  gain_threshold=0.0,   # force exactly mi iterations
              ))

    # convergence quality at reduced budgets: final cost + iters with the
    # real gain threshold
    for ci in (40, 20, 10):
        st, cost, it = bb.run_ba_fused(graph, w, max_iters=100,
                                       cg_iters=ci, gain_threshold=1e-4)
        print("gain-terminated cg_iters=%-3d -> %d iters, cost %.6e"
              % (ci, int(it), float(cost)), flush=True)


if __name__ == "__main__":
    main()
