"""Profile the CHAINED mode's host-side per-frame work (CPU backend).

The chained frame's host prep — shadow sampling, mask recovery, bundle
packing — runs identically on any backend, so it is profiled here on
the CPU backend.  This script cProfiles the track() loop at the bench
configuration and prints the top host functions, excluding device
execution (jax dispatch/block shows up separately and is NOT the
target here).

Usage: python examples/profile_chained_host.py [n_frames]
"""

import cProfile
import pstats
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))

from synthetic import SynthConfig, SynthSequence, synth_settings  # noqa: E402

from sdpl_slam_tpu.models.system import System  # noqa: E402


def main():
    n_req = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    cfg = SynthConfig(
        n_frames=n_req + 1, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=0.2,
    )
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.max_track_point_bg = 1200
    settings.max_track_point_obj = 800
    settings.max_static_lines = 400
    settings.max_objects = 8
    settings.th_depth_bg = 40.0
    settings.th_depth_obj = 25.0
    settings.min_object_points = 150
    settings.use_sample_fea = 0
    settings.run_local_ba = False        # LBA cost profiled separately
    settings.chained_tracking = True

    system = System(settings, verbose=False)
    n = seq.n_frames - 1
    frames = [seq.frame(t) for t in range(n)]

    # warm every program with the first frames OUTSIDE the profile
    warm = 4
    for t in range(warm):
        f = frames[t]
        nxt = frames[t + 1] if t + 1 < n else None
        nxt2 = frames[t + 2] if t + 2 < n else None
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,
            next_image=None if nxt is None else nxt.gray,
            next_image2=None if nxt2 is None else nxt2.gray,
        )

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for t in range(warm, n):
        f = frames[t]
        nxt = frames[t + 1] if t + 1 < n else None
        nxt2 = frames[t + 2] if t + 2 < n else None
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,
            next_image=None if nxt is None else nxt.gray,
            next_image2=None if nxt2 is None else nxt2.gray,
        )
    prof.disable()
    wall = time.perf_counter() - t0
    system.tracker.flush()

    nf = n - warm
    print(f"== {nf} frames in {wall:.2f}s = {wall / nf * 1e3:.1f} ms/frame "
          "(CPU backend: device exec is CPU-slow; read the HOST rows) ==")
    st = pstats.Stats(prof)
    st.sort_stats("cumulative")
    print("\n-- top by cumulative --")
    st.print_stats(r"chained|resident|tracking|frame|prefetch|numpy", 25)
    st.sort_stats("tottime")
    print("\n-- top by self time (all) --")
    st.print_stats(30)


if __name__ == "__main__":
    main()
