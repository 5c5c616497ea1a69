"""Sequence loaders for the reference's on-disk dataset layout.

Replicates /root/reference/example/sdpl_slam.cc:164-466 (``LoadData`` /
``LoadMask``):

    <seq>/times.txt                  one timestamp per line
    <seq>/image_0/%06d.png           RGB (or gray) images
    <seq>/depth/%06d.png             16-bit depth/disparity PNGs -> float32
    <seq>/semantic/%06d.txt          whitespace-separated integer label matrix
    <seq>/flow/%06d.flo              Middlebury .flo dense optical flow
    <seq>/pose_gt.txt                frame_id + 16 floats (row-major 4x4)
    <seq>/object_pose.txt            10 floats per row (frame_id obj_id
                                     B1 B2 B3 B4 t1 t2 t3 r1) -- KITTI format
                                     consumed by ObjPoseParsingKT
                                     (/root/reference/src/Tracking.cc:3134)

The readers return numpy arrays; staging to device happens in prefetch.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

_FLO_MAGIC = 202021.25  # Middlebury sanity-check value ("PIEH" as float)


def read_flo(path: str | Path) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32 (u, v).
    Uses the native reader (io/native.py) when built."""
    from . import native

    if native.available():
        out = native.read_flo(str(path))
        if out is not None:
            return out
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise ValueError(f"{path}: not a .flo file (magic {magic})")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as .flo (for fixtures/tests)."""
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_mask_txt(path: str | Path,
                  shape: Optional[tuple] = None) -> np.ndarray:
    """Read a whitespace-separated integer label matrix -> (H, W) int32.

    Matches ``LoadMask`` (/root/reference/example/sdpl_slam.cc:269-466),
    minus the visualization.  With a known ``shape`` the native mmap
    scanner is used (~20x faster than np.loadtxt on KITTI-size masks).
    """
    if shape is not None:
        from . import native

        if native.available():
            out = native.parse_int_matrix(str(path), shape[0], shape[1])
            if out is not None:
                return out
    return np.loadtxt(path, dtype=np.int32)


def _cv2(reader: str):
    """OpenCV, imported on first use: only image reads the native decoder
    cannot serve need it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{reader} needs OpenCV (the cv2 package) for this file: it is "
            f"not a PNG, or the native PNG decoder (native/) is not built"
        ) from e
    return cv2


def _gray_postprocess(im: np.ndarray) -> np.ndarray:
    """Native-decoded PNG -> grayscale, shared by the per-file and
    batched loaders."""
    if im.ndim == 3 and im.shape[-1] >= 3:
        # PNG channel order is RGB; cvtColor luma weights
        wts = np.array([0.299, 0.587, 0.114], np.float32)
        im = (
            im[..., :3].astype(np.float32) @ wts
        ).round().astype(im.dtype)
    elif im.ndim == 3:
        # gray+alpha (color type 4): luma is channel 0
        im = np.ascontiguousarray(im[..., 0])
    # 16-bit grayscale: returned as-is, matching the cv2
    # IMREAD_UNCHANGED fallback (one convention, both paths)
    return im


def read_image_gray(path: str | Path) -> np.ndarray:
    """Load an image as uint8 grayscale (reference converts RGB->gray,
    /root/reference/src/Tracking.cc:224-237).  Prefers the native libpng
    decoder (native/sdpl_io.cpp) and falls back to cv2 for non-PNG."""
    from . import native

    if native.available() and str(path).lower().endswith(".png"):
        im = native.read_png(str(path))
        if im is not None:
            return _gray_postprocess(im)
    cv2 = _cv2("read_image_gray")
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if im is None:
        raise FileNotFoundError(path)
    if im.ndim == 3:
        im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
    return im


def read_depth_png(path: str | Path) -> np.ndarray:
    """Load a depth/disparity PNG as float32 (reference: imread UNCHANGED
    then convertTo CV_32F, /root/reference/example/sdpl_slam.cc:110-113).
    Prefers the native libpng decoder."""
    from . import native

    if native.available() and str(path).lower().endswith(".png"):
        im = native.read_png(str(path))
        if im is not None and im.ndim == 2:
            return im.astype(np.float32)
    cv2 = _cv2("read_depth_png")
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if im is None:
        raise FileNotFoundError(path)
    return im.astype(np.float32)


@dataclass
class Sequence:
    """Lazy handle to a sequence directory (reference dataset layout)."""

    root: Path
    timestamps: np.ndarray            # (T,)
    poses_gt: np.ndarray              # (T, 4, 4) float32
    obj_poses_gt: List[List[np.ndarray]]  # per frame: list of 10-float rows

    @property
    def n_frames(self) -> int:
        """Number of processable frames: nImages = len-1 (the last frame has
        no forward flow; example/sdpl_slam.cc:62)."""
        return max(len(self.timestamps) - 1, 0)

    def rgb_path(self, i: int) -> Path:
        return self.root / "image_0" / f"{i:06d}.png"

    def frame(self, i: int):
        """Load raw inputs for frame i: (gray, depth_f32, flow, mask).

        The four files are read with ONE batched native submission
        (io_uring when the kernel allows it — native/sdpl_io.cpp
        sdpl_read_files_batch) and parsed from memory; any piece that
        fails falls back to its per-file reader."""
        from . import native

        rgb = self.rgb_path(i)
        dp = self.root / "depth" / f"{i:06d}.png"
        fp = self.root / "flow" / f"{i:06d}.flo"
        mp = self.root / "semantic" / f"{i:06d}.txt"
        gray = depth = flow = mask = None
        if native.available() and str(rgb).lower().endswith(".png"):
            bufs = native.read_files_batch([rgb, dp, fp, mp])
            if bufs is not None:
                if bufs[0] is not None:
                    im = native.parse_png(bufs[0])
                    if im is not None:
                        gray = _gray_postprocess(im)
                if bufs[1] is not None:
                    im = native.parse_png(bufs[1])
                    if im is not None and im.ndim == 2:
                        depth = im.astype(np.float32)
                if bufs[2] is not None:
                    flow = native.parse_flo(bufs[2])
                if bufs[3] is not None and gray is not None:
                    mask = native.parse_int_matrix_bytes(
                        bufs[3], gray.shape[0], gray.shape[1]
                    )
        if gray is None:
            gray = read_image_gray(rgb)
        if depth is None:
            depth = read_depth_png(dp)
        if flow is None:
            flow = read_flo(fp)
        if mask is None:
            mask = read_mask_txt(mp, shape=gray.shape)
        return gray, depth, flow, mask

    def gt_pose(self, i: int) -> np.ndarray:
        if i < len(self.poses_gt):
            return self.poses_gt[i]
        return np.eye(4, dtype=np.float32)

    def gt_obj_poses(self, i: int) -> List[np.ndarray]:
        if i < len(self.obj_poses_gt):
            return self.obj_poses_gt[i]
        return []


def load_sequence(path: str | Path) -> Sequence:
    """Parse the sequence-level metadata files (images load lazily)."""
    root = Path(path)
    timestamps = np.loadtxt(root / "times.txt", dtype=np.float64, ndmin=1)

    poses = []
    pose_file = root / "pose_gt.txt"
    if pose_file.exists():
        raw = np.loadtxt(pose_file, dtype=np.float64, ndmin=2)
        for row in raw:
            # frame_id + 16 floats row-major (example/sdpl_slam.cc:211-240)
            poses.append(row[1:17].reshape(4, 4).astype(np.float32))
    poses_gt = (
        np.stack(poses)
        if poses
        else np.broadcast_to(
            np.eye(4, dtype=np.float32), (len(timestamps), 4, 4)
        ).copy()
    )

    obj_poses: List[List[np.ndarray]] = [[] for _ in range(len(timestamps))]
    obj_file = root / "object_pose.txt"
    if obj_file.exists():
        raw = np.loadtxt(obj_file, dtype=np.float64, ndmin=2)
        if raw.size:
            for row in raw:
                f_id = int(row[0])
                if f_id < len(obj_poses):
                    # rows kept as the 10-float format ObjPoseParsingKT expects
                    obj_poses[f_id].append(row[:10].astype(np.float32))
    return Sequence(root, timestamps, poses_gt, obj_poses)
