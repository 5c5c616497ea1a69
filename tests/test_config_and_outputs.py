"""Config parsing of the shipped example yamls + output subsystems."""

from pathlib import Path

import numpy as np
import pytest

from sdpl_slam_tpu.utils import metrics
from sdpl_slam_tpu.utils.config import (
    KITTI, OMD, load_settings, parse_filestorage,
)

from synthetic import SynthConfig, SynthSequence, synth_settings

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# The reference's example/{kitti,omd,tum}.yaml values, pinned here: the
# shipped examples/*.yaml must reproduce every one of them.
REFERENCE = {
    "kitti.yaml": dict(
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.8540,
        width=1242, height=375, fps=10.0, bf=387.5744, rgb=1,
        choose_data=KITTI, depth_map_factor=256.0,
        th_depth_bg=40.0, th_depth_obj=25.0,
        max_track_point_bg=1200, max_track_point_obj=800,
        sf_mg_thres=0.12, sf_ds_thres=0.3, window_size=20, overlap_size=4,
        use_sample_fea=0, orb_n_features=2500, orb_scale_factor=1.2,
        orb_n_levels=8, orb_ini_th_fast=20, orb_min_th_fast=7,
    ),
    "omd.yaml": dict(
        fx=618.3587036132812, fy=618.5924072265625,
        cx=328.9866333007812, cy=237.7507629394531,
        width=640, height=480, fps=30.0, bf=387.5744, rgb=1,
        choose_data=OMD, depth_map_factor=1000.0,
        th_depth_bg=40.0, th_depth_obj=25.0,
        max_track_point_bg=1200, max_track_point_obj=800,
        sf_mg_thres=0.02, sf_ds_thres=0.99, window_size=20, overlap_size=4,
        use_sample_fea=1, orb_n_features=3000, orb_scale_factor=1.2,
        orb_n_levels=8, orb_ini_th_fast=20, orb_min_th_fast=7,
    ),
    "tum.yaml": dict(
        fx=517.3, fy=516.5, cx=318.6, cy=255.3,
        width=640, height=480, fps=10.0, bf=387.5744, rgb=1,
        choose_data=OMD, depth_map_factor=256.0,
        th_depth_bg=40.0, th_depth_obj=25.0,
        max_track_point_bg=1200, max_track_point_obj=800,
        sf_mg_thres=0.12, sf_ds_thres=0.3, window_size=20, overlap_size=4,
        use_sample_fea=0, orb_n_features=2500, orb_scale_factor=1.2,
        orb_n_levels=8, orb_ini_th_fast=20, orb_min_th_fast=7,
    ),
}


def test_kitti_yaml_parses():
    s = load_settings(EXAMPLES / "kitti.yaml")
    assert s.fx == pytest.approx(721.5377)
    assert s.bf == pytest.approx(387.5744)
    assert s.choose_data == KITTI
    assert s.depth_map_factor == 256.0
    assert s.th_depth_bg == 40.0 and s.th_depth_obj == 25.0
    assert s.max_track_point_bg == 1200 and s.max_track_point_obj == 800
    assert s.sf_mg_thres == pytest.approx(0.12)
    assert s.sf_ds_thres == pytest.approx(0.3)
    assert s.window_size == 20 and s.overlap_size == 4
    assert s.use_sample_fea == 0
    assert s.orb_n_features == 2500 and s.orb_n_levels == 8
    assert s.orb_ini_th_fast == 20 and s.orb_min_th_fast == 7


def test_omd_yaml_parses():
    s = load_settings(EXAMPLES / "omd.yaml")
    assert s.choose_data == OMD
    assert (s.width, s.height) == (640, 480)
    assert s.depth_map_factor == 1000.0
    assert s.use_sample_fea == 1 and s.orb_n_features == 3000


def test_shipped_example_yamls_match_reference():
    """examples/{kitti,omd,tum}.yaml (the entry point of
    examples/run_sequence.py) hold the reference's values on every mapped
    key, with the right types."""
    for name, ref in REFERENCE.items():
        s = load_settings(EXAMPLES / name)
        for key, want in ref.items():
            got = getattr(s, key)
            assert type(got) is type(want), (name, key, got, want)
            assert got == pytest.approx(want), (name, key, got, want)


@pytest.mark.parametrize("text, want", [
    # the OpenCV directive and the document marker are skipped
    ("%YAML:1.0\n---\nA: 1\n", {"A": 1}),
    # full-line and trailing comments
    ("# camera\nCamera.fx: 721.5  # focal\n", {"Camera.fx": 721.5}),
    # ints stay ints, floats floats
    ("n: 2500\nf: 1.2\nz: 0.0\n", {"n": 2500, "f": 1.2, "z": 0.0}),
    # negative and exponent numbers
    ("k1: -0.25\nn: -3\nh: 1e-4\nH: 2.5E+3\n",
     {"k1": -0.25, "n": -3, "h": 1e-4, "H": 2500.0}),
    # empty values and strings; indented (nested) lines are ignored
    ("a:\ns: LSD\nm: !!opencv-matrix\n  rows: 3\n",
     {"a": None, "s": "LSD", "m": "!!opencv-matrix"}),
])
def test_filestorage_parser(text, want):
    got = parse_filestorage(text)
    assert got == want
    for k, v in want.items():
        assert type(got[k]) is type(v), (k, got[k])


def test_unknown_keys_ignored(tmp_path):
    p = tmp_path / "s.yaml"
    p.write_text("%YAML:1.0\nNoSuchKey: 5\nCamera.fx: -1.5e2\n"
                 "MaxTrackPointBG: 900\nStopFrame: 12\n")
    s = load_settings(p)
    assert s.fx == -150.0 and type(s.fx) is float
    assert s.max_track_point_bg == 900 and s.stop_frame == 12
    assert not hasattr(s, "NoSuchKey")


@pytest.fixture(scope="module")
def run():
    cfg = SynthConfig(n_frames=6, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.run_local_ba = False
    from sdpl_slam_tpu.models.system import System

    sys_ = System(settings, verbose=False)
    for t in range(5):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, 5, line_detections=f.lines)
    return sys_


def test_velocity_error(run):
    est, gt, per = run.velocity_error()
    # synthetic object speed ~0.9 m/frame * 36 = ~32 "km/h" units
    assert gt > 0
    assert abs(est - gt) / gt < 0.1, (est, gt)
    assert 1 in per


def test_object_track_time(run):
    tt = metrics.object_track_time(run.map)
    assert tt.get(1, 0) >= 3


def test_plotting_outputs(tmp_path, run):
    from sdpl_slam_tpu.utils import plotting

    ok = plotting.plot_metric_error(run.map, tmp_path)
    if ok:  # matplotlib present
        assert (tmp_path / "camera_rpe.png").exists()
        assert (tmp_path / "trajectory.png").exists()
        assert (tmp_path / "object_motion_error.png").exists()
    plotting.write_tracklet_histograms(run.map, tmp_path)
    h = np.loadtxt(tmp_path / "track_distribution_static.txt")
    assert h.sum() > 0


def test_offline_evaluator(tmp_path):
    """examples/evaluate.py round-trips the written result files and
    reproduces the in-memory metric values."""
    import subprocess
    import sys as _sys

    from synthetic import SynthConfig, SynthSequence, synth_settings
    from sdpl_slam_tpu.models.system import System
    from sdpl_slam_tpu.utils import metrics

    cfg = SynthConfig(n_frames=6, n_objects=1)
    seq = SynthSequence(cfg)
    s = synth_settings(cfg)
    s.run_local_ba = False
    s.run_global_ba = False
    sys_ = System(s, verbose=False)
    n = seq.n_frames - 1
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, n, line_detections=f.lines)
    out = tmp_path / "res"
    sys_.save_results(str(out))

    root = Path(__file__).resolve().parents[1]
    _sys.path.insert(0, str(root / "examples"))
    import evaluate as ev

    ids, est = ev.read_pose_file(out / "initial_stereo_new.txt")
    _, gt = ev.read_pose_file(out / "cam_pose_gt_stereo.txt")
    assert len(est) == len(sys_.map.camera_poses)
    t_file, r_file = metrics.camera_rpe(est, gt)
    t_mem, r_mem = metrics.camera_rpe(
        sys_.map.camera_poses, sys_.map.camera_poses_gt
    )
    # file poses carry 9-decimal quantization; the clamped-trace acos
    # amplifies it near identity rotations
    assert abs(t_file - t_mem) < 1e-6
    assert abs(r_file - r_mem) < 5e-3
    # CLI runs end-to-end
    r = subprocess.run(
        [_sys.executable, str(root / "examples" / "evaluate.py"), str(out)],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    assert "camera initial" in r.stdout
