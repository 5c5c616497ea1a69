"""First-window LBA background precompile (ROADMAP / VERDICT r3 item 8).

The first local-BA trigger used to pay the whole fused-program compile
on the frame path
(PartialBatchOptimizationWithLines cadence,
/root/reference/src/Tracking.cc:1795-1804).  ``maybe_precompile_partial_async``
predicts the first window's shape buckets from the frames mapped so far
(steady-state replication of the last frame), primes the bucket ratchet,
and compiles the fused program in a daemon thread.  These tests assert
the two properties the optimization rests on:

 * prediction: the primed ratchet makes the REAL first window land in
   the precompiled buckets (no new fused-program compile at trigger);
 * correctness: results with precompile match results without (padding
   is masked; only shapes change).
"""

import numpy as np

from sdpl_slam_tpu.models.system import System
from sdpl_slam_tpu.solvers import ba_builder, batch_ba, schur_ba

from synthetic import SynthConfig, SynthSequence, synth_settings


def _settings(cfg, window=8, overlap=2):
    s = synth_settings(cfg)
    s.run_local_ba = True
    s.window_size, s.overlap_size = window, overlap
    return s


def _track(seq, settings, n):
    sys_ = System(settings, verbose=False)
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1, line_detections=f.lines,
        )
    sys_.tracker.flush()
    return sys_


def _fused_cache_size(settings):
    fn = (schur_ba.run_ba_fused_schur
          if settings.ba_schur else batch_ba.run_ba_fused)
    return fn._cache_size()


def test_precompile_predicts_first_window_buckets():
    cfg = SynthConfig(n_frames=11, n_objects=1, noise_flow=0.1)
    seq = SynthSequence(cfg)
    settings = _settings(cfg)

    sys_ = System(settings, verbose=False)
    n = 10
    size_after_precompile = None
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1, line_detections=f.lines,
        )
        m = sys_.map
        th = getattr(m, "_ba_precompile_thread", None)
        if th is not None and size_after_precompile is None:
            th.join()                      # let the background compile land
            size_after_precompile = _fused_cache_size(settings)
    sys_.tracker.flush()

    m = sys_.map
    assert getattr(m, "_ba_precompiled", False), "precompile never fired"
    assert size_after_precompile is not None
    assert len(m.lba_times) >= 1, "no LBA window ran"
    # the real first window must have hit the precompiled executable:
    # no new fused-program cache entry after the trigger
    assert _fused_cache_size(settings) == size_after_precompile, (
        "first real window missed the precompiled buckets"
    )


def test_precompile_does_not_change_results():
    cfg = SynthConfig(n_frames=11, n_objects=1, noise_flow=0.1)
    seq = SynthSequence(cfg)
    n = 10

    s_on = _settings(cfg)
    sys_on = _track(seq, s_on, n)

    s_off = _settings(cfg)
    sys_off = System(s_off, verbose=False)
    sys_off.map._ba_precompiled = True     # disarm the one-shot hook
    for t in range(n):
        f = seq.frame(t)
        sys_off.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1, line_detections=f.lines,
        )
    sys_off.tracker.flush()

    a, b = sys_on.map, sys_off.map
    assert len(a.lba_times) == len(b.lba_times) >= 1
    for pa, pb in zip(a.camera_poses, b.camera_poses):
        # identical math modulo padded-reduction rounding
        np.testing.assert_allclose(pa, pb, atol=1e-4, rtol=1e-5)
    assert a.rm_labels == b.rm_labels


def test_persisted_floors_warm_start(tmp_path, monkeypatch):
    """Floors persisted by one run let a fresh System (fresh process in
    production; the jit cache carries over here, which is exactly what
    the assertion leans on) precompile from frame 0 — the dummy graph
    built from floors must hit the SAME executable as the real window."""
    monkeypatch.setenv("SDPL_BA_FLOORS", str(tmp_path / "floors.json"))

    cfg = SynthConfig(n_frames=11, n_objects=1, noise_flow=0.1)
    seq = SynthSequence(cfg)
    n = 10
    settings = _settings(cfg, window=6, overlap=2)

    # run 1: no precompile; the trigger compiles and persists floors
    sys1 = System(settings, verbose=False)
    sys1.map._ba_precompiled = True
    for t in range(n):
        f = seq.frame(t)
        sys1.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1, line_detections=f.lines,
        )
    sys1.tracker.flush()
    assert len(sys1.map.lba_times) >= 1

    floors = ba_builder.load_persisted_floors(settings)
    assert floors is not None
    assert all(i in floors for i in range(ba_builder._N_BUILD_SITES))

    size0 = _fused_cache_size(settings)

    # run 2: the hook must fire the floors path before any data exists
    sys2 = System(settings, verbose=False)
    fired_early = False
    for t in range(n):
        f = seq.frame(t)
        sys2.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1, line_detections=f.lines,
        )
        th = getattr(sys2.map, "_ba_precompile_thread", None)
        if th is not None and not fired_early:
            fired_early = sys2.map.n_frames < 4
            th.join()
    sys2.tracker.flush()

    assert fired_early, "floors precompile did not fire before data"
    assert len(sys2.map.lba_times) >= 1
    # dummy + real window both land on run 1's executable
    assert _fused_cache_size(settings) == size0, (
        "floors-primed dummy or real window missed run 1's executable"
    )


def test_shape_snapshot_extends_to_window():
    cfg = SynthConfig(n_frames=6, n_objects=1)
    seq = SynthSequence(cfg)
    settings = _settings(cfg)
    settings.run_local_ba = False
    sys_ = _track(seq, settings, 5)
    m = sys_.map
    snap = ba_builder._shape_snapshot(m, 12)
    for name in ba_builder._SNAPSHOT_FIELDS:
        src = getattr(m, name)
        ext = getattr(snap, name)
        if len(src):
            assert len(ext) == max(len(src), 12), name
            assert ext[-1] is src[-1], name
    # the extended snapshot must be consumable by build_graph at the
    # full window width
    graph, _ = ba_builder.build_graph(
        snap, sys_.tracker.K, 0, 12, motion_init_identity=False,
        prior_info=1e7, use_lines=True,
    )
    assert int(graph.cam_T0.shape[0]) == 12
