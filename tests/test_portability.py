"""What the package needs from its host: no PyYAML or OpenCV on the main
path, the same synthetic frames everywhere, the compile-cache location,
one FAST code path on every backend, and the smoke run's contract."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import sdpl_slam_tpu
from synthetic import SynthConfig, SynthSequence, draw_strokes

ROOT = Path(__file__).resolve().parents[1]


def test_system_imports_without_yaml_and_cv2():
    body = ("import sys; sys.modules['yaml'] = None; "
            "sys.modules['cv2'] = None; "
            "import sdpl_slam_tpu.models.system; "
            "from sdpl_slam_tpu.utils.config import load_settings; "
            "print(load_settings('examples/kitti.yaml').width)")
    r = subprocess.run(
        [sys.executable, "-c", body], capture_output=True, text=True,
        cwd=ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("1242"), r.stdout


def test_synthetic_strokes_without_cv2(monkeypatch):
    """With OpenCV unimportable the rendered frame still carries every
    projected structure line as a dark stroke."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = SynthConfig(n_frames=1, n_objects=0)
    f = SynthSequence(cfg, cache=False).frame(0)
    assert len(f.lines) >= 5
    for sx, sy, ex, ey in f.lines:
        for t in (0.25, 0.5, 0.75):
            u = int(np.floor(sx + (ex - sx) * t + 0.5))
            v = int(np.floor(sy + (ey - sy) * t + 0.5))
            assert (f.gray[v - 1:v + 2, u - 1:u + 2] == 20).any(), (u, v)


def test_strokes_match_opencv_footprint():
    """The numpy raster covers what OpenCV's 2-px line covers."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    inter = union = 0
    for _ in range(200):
        p = rng.integers(0, 60, 4)
        a = np.zeros((64, 64), np.uint8)
        b = a.copy()
        cv2.line(a, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), 1, 2)
        draw_strokes(b, p[None].astype(np.float32), 1)
        inter += int((a & b).sum())
        union += int((a | b).sum())
    assert inter / union > 0.85, inter / union


def test_strokes_clip_to_image():
    img = np.zeros((10, 12), np.uint8)
    draw_strokes(img, np.array([[-5, 4, 20, 4]], np.float32), 7)
    assert (img[4] == 7).all() and (img[3] == 7).all()
    assert (img[:3] == 0).all() and (img[6:] == 0).all()


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_left_alone_when_configured(monkeypatch, tmp_path,
                                              restore_cache_dir):
    """A directory from JAX_COMPILATION_CACHE_DIR (or the caller) wins."""
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sdpl_slam_tpu.maybe_enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_defaults_to_checkout_on_gpu(monkeypatch,
                                               restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = sdpl_slam_tpu.maybe_enable_persistent_cache()
    want = str(ROOT / ".jax_cache")
    assert got == want == sdpl_slam_tpu.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == want
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cpu_backend_stays_uncached(restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    assert jax.default_backend() == "cpu"
    assert sdpl_slam_tpu.maybe_enable_persistent_cache() is None
    assert not jax.config.jax_compilation_cache_dir


def test_detect_keypoints_has_one_path(monkeypatch):
    """The traced program does not depend on the backend's name."""
    import jax.numpy as jnp

    from sdpl_slam_tpu.ops import fast

    img = jnp.zeros((192, 320), jnp.uint8)
    cfg = fast.FastPyramidConfig(n_features=300, n_levels=2)
    raw = fast.detect_keypoints.__wrapped__
    jaxprs = []
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        jaxprs.append(str(jax.make_jaxpr(lambda x: raw(x, cfg))(img)))
    assert jaxprs[0] == jaxprs[1] == jaxprs[2]
    assert "pallas" not in jaxprs[0]


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    return chip_smoke


def test_smoke_result_line_format(chip_smoke):
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_smoke_refuses_cpu(chip_smoke, monkeypatch, capsys):
    """No GPU: a non-zero exit and no result line."""
    monkeypatch.setenv("SDPL_TEST_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script fails and prints no
    result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cv2_uses_name_the_package(monkeypatch, tmp_path):
    """The off-main-path OpenCV uses fail with an error naming cv2."""
    from sdpl_slam_tpu.io import dataset
    from sdpl_slam_tpu.utils import traj_canvas

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        dataset.read_image_gray(tmp_path / "frame.jpg")
    with pytest.raises(ImportError, match="cv2"):
        dataset.read_depth_png(tmp_path / "depth.tiff")
    with pytest.raises(ImportError, match="cv2"):
        traj_canvas.draw_frame(np.zeros((600, 600, 3), np.uint8),
                               np.eye(4), [], [])
