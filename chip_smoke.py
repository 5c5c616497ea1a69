#!/usr/bin/env python3
"""Smoke run of the SLAM pipeline on one GPU.

    python chip_smoke.py

One process on one card, in order:

1. environment: JAX version and devices, the card's name and power limit,
   which host I/O library loaded, the compile-cache directory;
2. component parity at KITTI width (1242x375), the GPU against the CPU
   backend of the same process: FAST score map, FAST pyramid keypoints,
   line detection, the joint flow+pose camera solver, one batch-BA
   damped-GN step on a 20-frame window graph;
3. the main path: the 44-frame KITTI-scale host-vs-chained parity run of
   tests/test_chained_kitti.py with the product BA (fused), the resident
   path over 12 frames against the bench accuracy gates, the global BA on
   the chained map and the 7 result files;
4. the GPU test lane (tests/test_gpu_lane.py), in this process;
5. timings (printed, not gated).

Any failed phase raises, and the script exits non-zero.  It also exits
non-zero when JAX finds no GPU: there is no CPU fallback.  The last line
of standard output on success is one JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TESTS = ROOT / "tests"

# KITTI-scale frame and capacities (examples/kitti.yaml)
H, W = 375, 1242


def result_line(devices) -> str:
    """The last line of a successful run, naming the device as JAX
    reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_line() -> str:
    """``name, power limit`` of the card, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's name, result and wall time; never swallows."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _say(f"[phase] {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        _say(f"[phase] {self.name}: {'FAILED' if exc_type else 'ok'} "
             f"({dt:.1f} s)")
        return False


def _on(dev, fn, *args):
    """Run ``fn(*args)`` with its inputs committed to ``dev``; returns the
    result as numpy."""
    import jax
    import numpy as np

    with jax.default_device(dev):
        out = fn(*jax.device_put(args, dev))
    return jax.tree.map(np.asarray, out)


def _kitti_frame():
    """Frame 0 of the KITTI-scale synthetic sequence (tests/synthetic.py)."""
    from synthetic import SynthConfig, SynthSequence

    cfg = SynthConfig(n_frames=1, n_objects=2, width=W, height=H,
                      fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854)
    return SynthSequence(cfg, cache=False).frame(0).gray


def parity_fast_score(gpu, cpu, img):
    import jax.numpy as jnp
    import numpy as np

    from sdpl_slam_tpu.ops import fast

    x = jnp.asarray(img, jnp.float32)
    a = _on(gpu, fast.fast_score_map, x, 20.0)
    b = _on(cpu, fast.fast_score_map, x, 20.0)
    # equal: on a uint8 frame every score is a sum of 16 integer-valued
    # f32 terms below 2**24, exact in any summation order
    np.testing.assert_array_equal(a, b)
    _say(f"  fast_score_map {img.shape}: equal, {(a > 0).sum()} corners")


def parity_keypoints(gpu, cpu, img):
    import numpy as np

    from sdpl_slam_tpu.ops import fast

    cfg = fast.FastPyramidConfig()         # the KITTI ORBextractor config
    ug, _, vg = _on(gpu, lambda im: fast.detect_keypoints(im, cfg), img)
    uc, _, vc = _on(cpu, lambda im: fast.detect_keypoints(im, cfg), img)
    kg = {tuple(p) for p in ug[vg].tolist()}
    kc = {tuple(p) for p in uc[vc].tolist()}
    same = len(kg & kc) / max(len(kg), len(kc), 1)
    # >= 99 % identical: the resized pyramid levels are not integer-valued,
    # so last-bit differences in the bilinear resize can reorder top_k ties
    assert same >= 0.99, (same, len(kg), len(kc))
    _say(f"  detect_keypoints: {len(kg)} vs {len(kc)} keypoints, "
         f"{100 * same:.2f} % identical")


def parity_lines(gpu, cpu, img):
    import numpy as np

    from sdpl_slam_tpu.ops import lines

    # the tracker's KITTI line config (models/tracking.py _line_cfg)
    cfg = lines.LineDetectConfig(max_lines=800, min_length=8.0)
    sg = _on(gpu, lambda im: lines.detect_lines(im, cfg), img)
    sc = _on(cpu, lambda im: lines.detect_lines(im, cfg), img)
    a, b = sg.uv4[sg.valid], sc.uv4[sc.valid]
    # The sub-pixel PCA fits, the NFA gate and the endpoint walk compare
    # f32 values whose last bits depend on the reduction order, so a
    # borderline segment can differ.  Allowed: 2 % of the segments, at
    # least one -- in the count, and in segments without a counterpart
    # whose endpoints (either order) lie within 0.5 px.
    slack = max(1, int(0.02 * len(b)))
    assert abs(len(a) - len(b)) <= slack, (len(a), len(b))
    d_fwd = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    d_rev = np.abs(a[:, None, :] - b[None, :, [2, 3, 0, 1]]).max(-1)
    best = np.minimum(d_fwd, d_rev).min(1)
    matched = int((best <= 0.5).sum())
    assert min(len(a), len(b)) - matched <= slack, (matched, len(a), len(b))
    _say(f"  detect_lines: {len(a)} vs {len(b)} segments, {matched} "
         f"within 0.5 px; offsets of the rest (px): "
         f"{np.round(best[best > 0.5], 2).tolist()}")


def parity_flow_pose(gpu, cpu):
    import jax
    import numpy as np

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    fn = jax.jit(fn)
    pg, ig = _on(gpu, fn, *args)
    pc, ic = _on(cpu, fn, *args)
    # f32 LM solve: the normal-equation reductions run in another order
    # on each backend; the pose agrees to the solver's f32 noise
    np.testing.assert_allclose(pg, pc, atol=5e-4)
    _say(f"  solve_flow_pose (1200 pts, 400 lines): max |dpose| "
         f"{np.abs(pg - pc).max():.2e}, inlier agreement "
         f"{(ig == ic).mean():.4f}")


def parity_ba_step(gpu, cpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sdpl_slam_tpu.parallel import sharded_ba
    from sdpl_slam_tpu.solvers import batch_ba as bb
    from test_sharded_ba import _synth_big_graph

    g, n_edges = _synth_big_graph(F=20, stat_per_frame=600,
                                  dyn_per_frame=300)
    w = bb.BAWeights()
    step = jax.jit(bb.ba_gn_step, static_argnames=("cg_iters", "w"))

    def run(graph):
        return step(graph, sharded_ba.state_from_graph(graph), w,
                    jnp.asarray(1e-4, jnp.float32), cg_iters=10)

    dg, cg, _ = _on(gpu, run, g)
    dc, cc, _ = _on(cpu, run, g)
    # the tolerances of tests/test_sharded_ba.py: f32 reductions over
    # ~60k edges in another order; line families are not in this graph
    np.testing.assert_allclose(float(cg), float(cc), rtol=1e-4)
    worst = {}
    for k in ("cam", "mot", "xs"):
        np.testing.assert_allclose(dg[k], dc[k], atol=5e-4, err_msg=k)
        worst[k] = float(np.abs(dg[k] - dc[k]).max())
    _say(f"  ba_gn_step (20 frames, {n_edges} edges): cost {float(cg):.6g} "
         f"vs {float(cc):.6g}; max |delta| {worst}")


def main_path(timings):
    import numpy as np

    from sdpl_slam_tpu.solvers import ba_builder
    from sdpl_slam_tpu.utils import metrics
    import test_chained_kitti as tck

    times = {}
    host, chained, seq = tck.kitti_parity_main(ba_fused=True, times=times)
    _say(f"  host LBA windows (ms): {[round(x) for x in host.map.lba_times]}")
    _say(f"  chained LBA windows (ms): "
         f"{[round(x) for x in chained.map.lba_times]}")
    timings["chained"] = (times["chained"], list(chained.map.lba_times))
    timings["host"] = (times["host"], list(host.map.lba_times))

    # resident path, 12 frames at the same settings: the bench gates
    from synthetic import synth_settings

    s = tck._kitti_settings(seq.cfg, synth_settings, False, True)
    s.resident_tracking = True
    rtimes = []
    res = tck._run_path(seq, s, 12, times=rtimes)
    t_err, r_err = metrics.camera_rpe(res.map.camera_poses,
                                      res.map.camera_poses_gt)
    assert t_err < 0.005 and r_err < 0.1, (t_err, r_err)
    _say(f"  resident 12 frames: RPE {t_err:.2e} m / {r_err:.4f} deg")
    timings["resident"] = (rtimes, [])

    # global BA on the chained map, then the reference's result files
    t0 = time.perf_counter()
    cost = ba_builder.full_batch_optimization(
        chained.map, chained.tracker.K, chained.settings)
    timings["global_ba_s"] = time.perf_counter() - t0
    assert np.isfinite(cost), cost
    with tempfile.TemporaryDirectory() as d:
        chained.save_results(d)
        names = ("obj_mot_stereo_new.txt", "obj_mot_stereo_rf_new.txt",
                 "obj_mot_gt.txt", "obj_centre.txt",
                 "initial_stereo_new.txt", "refined_stereo_new.txt",
                 "cam_pose_gt_stereo.txt")
        missing = [n for n in names if not (Path(d) / n).is_file()]
        assert not missing, missing
    _say(f"  global BA cost {cost:.6g} "
         f"({timings['global_ba_s']:.1f} s); 7 result files written")


def gpu_lane():
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    c = Count()
    rc = pytest.main([str(TESTS / "test_gpu_lane.py"), "-q", "-m", "gpu",
                      "--durations=0",
                      "-p", "no:cacheprovider", "-p", "no:randomly"],
                     plugins=[c])
    assert rc == 0 and c.passed > 0 and not c.failed, (rc, c.passed,
                                                       c.failed)
    _say(f"  GPU lane: {c.passed} passed")


def print_timings(timings, card):
    import numpy as np

    for path in ("chained", "host", "resident"):
        if path not in timings:
            continue
        t, lba = timings[path]
        warm = np.median(t[4:]) * 1e3 if len(t) > 4 else float("nan")
        first = f"{lba[0]:.1f} ms" if lba else "none"
        # the pipelined paths run frame 0's device step during frames 1-2,
        # so the cold start is the sum over the first three frames
        _say(f"[timing] {path}: frames 0-2 {sum(t[:3]):.2f} s "
             f"({', '.join(f'{x:.2f}' for x in t[:3])}; compiles included), "
             f"first LBA window {first}, warm per-frame median "
             f"{warm:.1f} ms over frames 4+ [{card}]")
    if "global_ba_s" in timings:
        _say(f"[timing] global BA {timings['global_ba_s']:.2f} s [{card}]")


def main() -> int:
    if not (ROOT / "sdpl_slam_tpu").is_dir() or not TESTS.is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(sdpl_slam_tpu/ and tests/ are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(TESTS))
    # the GPU lane keeps the real backend (tests/conftest.py)
    os.environ["SDPL_TEST_PLATFORM"] = "gpu"

    import jax

    with Phase("environment"):
        _say(f"  jax {jax.__version__}; devices {jax.devices()}")
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise SystemExit(
                f"chip_smoke.py needs a GPU; JAX's first device is "
                f"{dev.platform!r}")
        card = card_line()
        _say(f"  card: {card}")
        import sdpl_slam_tpu
        from sdpl_slam_tpu.io import native

        sdpl_slam_tpu.maybe_enable_persistent_cache()
        _say("  host I/O: " + (
            f"C++ library {native._NATIVE_DIR / 'libsdpl_io.so'}"
            if native.available() else
            f"numpy fallback (C++ library not built: {native.load_error()})"))
        _say(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    gpu, cpu = jax.devices("gpu")[0], jax.devices("cpu")[0]

    with Phase("component parity, GPU vs CPU"):
        img = _kitti_frame()
        parity_fast_score(gpu, cpu, img)
        parity_keypoints(gpu, cpu, img)
        parity_lines(gpu, cpu, img)
        parity_flow_pose(gpu, cpu)
        parity_ba_step(gpu, cpu)

    timings = {}
    with Phase("main path: KITTI-scale host vs chained, resident, global BA"):
        main_path(timings)

    with Phase("GPU lane (tests/test_gpu_lane.py)"):
        gpu_lane()

    print_timings(timings, card)
    _say(f"card: {card}")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
