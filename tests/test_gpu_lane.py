"""GPU test lane: hot-path computations on the card.

Run on a machine with a GPU, either through the smoke run, which runs
this lane in its own process after the other phases:

    python chip_smoke.py

or alone:

    SDPL_TEST_PLATFORM=gpu python -m pytest tests/test_gpu_lane.py -m gpu -q

On the CPU harness these tests skip (the ``gpu`` marker's fixture in
conftest.py).  Each test runs a hot-path computation on the GPU backend
and, where a CPU cross-check is meaningful, asserts agreement with the
CPU result within f32 tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _cpu():
    return jax.devices("cpu")[0]


def _gpu():
    return jax.devices("gpu")[0]


def test_flow_pose_solver_matches_cpu():
    from sdpl_slam_tpu.ops import geometry, lie
    from sdpl_slam_tpu.solvers import frame_solvers as fs

    rng = np.random.default_rng(0)
    K = geometry.Intrinsics(
        jnp.float32(721.5377), jnp.float32(721.5377),
        jnp.float32(609.5593), jnp.float32(172.8540),
    )
    T_true = lie.se3_exp(
        jnp.array([0.01, -0.02, 0.005, 0.3, 0.05, 0.5], jnp.float32))
    n = 256
    uv = jnp.asarray(
        rng.uniform([100, 50], [1142, 325], size=(n, 2)), jnp.float32)
    z = jnp.asarray(rng.uniform(3.0, 30.0, size=n), jnp.float32)
    X = geometry.backproject(K, uv, z)
    cur = geometry.project(K, lie.transform_point(T_true, X))
    flow = cur - uv
    pts = fs.PointBundle(obs=uv, flow0=flow, depth=z,
                         valid=jnp.ones(n, bool))
    lines = fs.LineBundle(
        obs=jnp.zeros((8, 4), jnp.float32),
        flow0=jnp.zeros((8, 4), jnp.float32),
        depth=jnp.ones((8, 2), jnp.float32),
        valid=jnp.zeros(8, bool),
    )

    def run(device):
        p = jax.device_put(pts, device)
        l = jax.device_put(lines, device)
        res = fs.solve_flow_pose(
            jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32),
            p, l, K, flow_prior_info=0.3, use_lines=False,
        )
        return np.asarray(res.pose), np.asarray(res.point_inlier)

    pose_g, inl_g = run(_gpu())
    pose_c, inl_c = run(_cpu())
    # both backends recover the true pose to sub-mm
    for pose in (pose_g, pose_c):
        E = pose @ np.linalg.inv(np.asarray(T_true))
        assert np.linalg.norm(E[:3, 3]) < 1e-3
    # and agree with each other to f32 solver tolerance
    np.testing.assert_allclose(pose_g, pose_c, atol=5e-4)
    assert (inl_g == inl_c).mean() > 0.99


def test_fast_score_map_matches_cpu():
    """The FAST score map on the GPU vs the same code on the CPU."""
    from sdpl_slam_tpu.ops import fast

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (384, 512), np.uint8)

    s_gpu = np.asarray(jax.device_put(
        fast.fast_score_map(
            jax.device_put(jnp.asarray(img, jnp.float32), _gpu()), 20.0
        ), _cpu()))
    s_cpu = np.asarray(
        fast.fast_score_map(
            jax.device_put(jnp.asarray(img, jnp.float32), _cpu()), 20.0))
    # identical integer-valued score maps expected (pure comparisons/sums)
    mismatch = np.abs(s_gpu - s_cpu) > 1e-3
    assert mismatch.mean() < 1e-4, mismatch.sum()


def test_detect_keypoints_on_gpu():
    from sdpl_slam_tpu.ops import fast

    rng = np.random.default_rng(2)
    img = np.full((375, 1242), 120, np.uint8)
    # plant corners
    ys = rng.integers(20, 355, 200)
    xs = rng.integers(20, 1222, 200)
    for y, x in zip(ys, xs):
        img[y:y + 3, x:x + 3] = 255
    uv, resp, valid = fast.detect_keypoints(
        jax.device_put(jnp.asarray(img), _gpu()),
        fast.FastPyramidConfig(n_features=500),
    )
    uv, valid = np.asarray(uv), np.asarray(valid)
    assert valid.sum() >= 150
    # detected corners should be near planted ones
    planted = np.stack([xs, ys], 1).astype(np.float32)
    d = np.linalg.norm(
        uv[valid][:, None, :] - planted[None, :, :], axis=-1).min(1)
    assert np.median(d) < 3.0, np.median(d)


def test_line_detector_on_gpu():
    from sdpl_slam_tpu.ops import lines as ld

    img = np.full((375, 1242), 100, np.uint8)
    img[100:103, 200:900] = 20          # horizontal bar
    img[50:300, 600:603] = 20           # vertical bar
    det = ld.detect_lines(
        jax.device_put(jnp.asarray(img), _gpu()))
    uv4 = np.asarray(det.uv4)[np.asarray(det.valid)]
    assert len(uv4) >= 2
    lens = np.linalg.norm(uv4[:, 2:] - uv4[:, :2], axis=1)
    assert lens.max() > 150


def _kitti_run(chained, n, **overrides):
    """Track ``n`` frames of the KITTI-scale sequence of
    tests/test_chained_kitti.py (1242x375, reference caps, 2 objects,
    local BA at window 20 / overlap 4) with the product BA settings.
    These are the settings of chip_smoke.py's main path, so after it the
    programs are already compiled in the process."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import test_chained_kitti as tck
    from synthetic import SynthSequence, synth_settings

    cfg = tck._cfg(0.0)
    settings = tck._kitti_settings(cfg, synth_settings, chained,
                                   ba_fused=True)
    for k, v in overrides.items():
        setattr(settings, k, v)
    return tck._run_path(SynthSequence(cfg), settings, n)


def test_batch_ba_step_on_gpu():
    """The global batch BA runs on the GPU over a 44-frame KITTI-scale
    map and the refined trajectory holds the accuracy gate."""
    from sdpl_slam_tpu.solvers import ba_builder
    from sdpl_slam_tpu.utils import metrics

    system = _kitti_run(True, 44)
    m = system.map
    cost = ba_builder.full_batch_optimization(
        m, system.tracker.K, system.settings)
    assert np.isfinite(cost)
    t1, r1 = metrics.camera_rpe(m.camera_poses_rf, m.camera_poses_gt)
    assert t1 < 0.02, t1


def test_resident_step_runs_on_gpu():
    """The device-resident frame loop (models/resident.py) executes on
    the GPU and tracks the KITTI-scale sequence to the same accuracy gate
    as the host path."""
    from sdpl_slam_tpu.utils import metrics

    sys_ = _kitti_run(False, 6, resident_tracking=True)
    t_err, r_err = metrics.camera_rpe(
        sys_.map.camera_poses, sys_.map.camera_poses_gt
    )
    assert t_err < 0.02, t_err
    assert r_err < 0.1, r_err


def test_chained_step_runs_on_gpu():
    """The chained loop (models/chained.py -- the benchmark
    configuration) executes on the GPU with the fused local BA and holds
    the accuracy gate."""
    from sdpl_slam_tpu.utils import metrics

    sys_ = _kitti_run(True, 22)          # the first window fires at 19
    assert len(sys_.map.lba_times) >= 1
    t_err, r_err = metrics.camera_rpe(
        sys_.map.camera_poses, sys_.map.camera_poses_gt
    )
    assert t_err < 0.02, t_err
    assert r_err < 0.2, r_err
