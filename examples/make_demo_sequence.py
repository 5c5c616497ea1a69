#!/usr/bin/env python
"""Render a synthetic dynamic sequence to disk in the reference dataset
layout, plus a matching settings.yaml — the self-contained demo input
for run_sequence.py (real KITTI/OMD data is not shipped in this image).

Usage: python examples/make_demo_sequence.py <out_dir> [n_frames] [n_objects]

Produces (example/sdpl_slam.cc:164-267 layout):

    <out_dir>/times.txt            timestamps
    <out_dir>/image_0/%06d.png     gray frames
    <out_dir>/depth/%06d.png       16-bit depth PNGs (factor 100)
    <out_dir>/semantic/%06d.txt    integer instance-label matrices
    <out_dir>/flow/%06d.flo        Middlebury forward flow
    <out_dir>/pose_gt.txt          camera GT (frame_id + 16 floats)
    <out_dir>/object_pose.txt      object GT rows (KITTI 10-float format)
    <out_dir>/settings.yaml        matching intrinsics/config

Then:  python examples/run_sequence.py <out_dir>/settings.yaml <out_dir> /tmp/demo_out
       python examples/evaluate.py /tmp/demo_out
"""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

# The renderer is pure host-side work: keep it off the GPU, so that it
# neither reserves the card's memory nor competes with a tracking run.
os.environ.setdefault("JAX_DISABLE_MOST_OPTIMIZATIONS", "1")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


SETTINGS_TEMPLATE = """%YAML:1.0
# Auto-generated by make_demo_sequence.py for the demo sequence here.
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: {width}
Camera.height: {height}
Camera.fps: 10.0
Camera.bf: 387.5744
Camera.RGB: 1
ChooseData: 1
DepthMapFactor: 100.0
ThDepthBG: 40.0
ThDepthOBJ: 25.0
MaxTrackPointBG: 1200
MaxTrackPointOBJ: 800
SFMgThres: 0.12
SFDsThres: 0.3
WINDOW_SIZE: 20
OVERLAP_SIZE: 4
UseSampleFeature: 0
ORBextractor.nFeatures: 2500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    import cv2

    from synthetic import SynthConfig, SynthSequence

    from sdpl_slam_tpu.io import dataset

    root = Path(argv[1])
    n = int(argv[2]) if len(argv) > 2 else 30
    n_objects = int(argv[3]) if len(argv) > 3 else 2

    cfg = SynthConfig(n_frames=n + 1, n_objects=n_objects,
                      noise_flow=0.2)
    seq = SynthSequence(cfg)

    for d in ("image_0", "depth", "semantic", "flow"):
        (root / d).mkdir(parents=True, exist_ok=True)
    np.savetxt(root / "times.txt", np.arange(n + 1) * 0.1, fmt="%.6f")
    poses, objposes = [], []
    for i in range(n + 1):
        f = seq.frame(i)
        cv2.imwrite(str(root / "image_0" / f"{i:06d}.png"), f.gray)
        cv2.imwrite(
            str(root / "depth" / f"{i:06d}.png"),
            (np.clip(f.depth, 0, 300) * 100).astype(np.uint16),
        )
        np.savetxt(root / "semantic" / f"{i:06d}.txt", f.mask, fmt="%d")
        dataset.write_flo(root / "flow" / f"{i:06d}.flo", f.flow)
        poses.append([i] + list(f.gt_pose.astype(np.float64).ravel()))
        for row in f.obj_rows:
            objposes.append(list(row) + [0.0] * max(0, 10 - len(row)))
        if i % 10 == 0:
            print(f"rendered frame {i}/{n}")
    np.savetxt(root / "pose_gt.txt", np.asarray(poses), fmt="%.9f")
    if objposes:
        np.savetxt(root / "object_pose.txt", np.asarray(objposes),
                   fmt="%.9f")
    (root / "settings.yaml").write_text(SETTINGS_TEMPLATE.format(
        fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
        width=cfg.width, height=cfg.height,
    ))
    print(f"demo sequence written to {root} ({n + 1} frames, "
          f"{n_objects} objects)")
    print(f"next: python examples/run_sequence.py {root}/settings.yaml "
          f"{root} /tmp/demo_out")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
