"""In-place bird's-eye trajectory canvas (the reference ``imTraj``).

The reference threads a caller-owned BGR canvas through the TrackRGBD
API (/root/reference/include/Tracking.h:67-69; the example creates a
1000x1000 white canvas, example/sdpl_slam.cc:93) and, for KITTI data,
draws per frame (/root/reference/src/Tracking.cc:836-907):

 * the camera position as a 5x5 RED square outline at
   ``(x, z) * scale + (300, 100)`` with scale 6 (:840-846),
 * a black header band with "Camera Trajectory (RED SQUARE)", the
   current camera xyz, and "Object Trajectories (COLORED CIRCLES)"
   (:847-852),
 * one radius-1 thickness-2 circle per live object at its 3D centre's
   (x, z), colored by tracking label through a fixed palette
   (:854-903).

Same semantics here, numpy/cv2 on the host (cv2 only for the header
text, imported when a canvas is drawn; the shapes are drawn with numpy).  The
reference's imshow windows are intentionally NOT replicated (headless
environments); the canvas itself is the API artifact.
"""

from __future__ import annotations

import numpy as np

# label -> BGR color; CV_RGB(r,g,b) stores BGR, mirrored verbatim from
# the switch at /root/reference/src/Tracking.cc:858-903
_LABEL_BGR = {
    1: (128, 0, 128),
    2: (255, 255, 0),
    3: (0, 255, 0),
    4: (255, 0, 0),
    5: (0, 255, 255),
    6: (128, 0, 128),
    7: (255, 255, 255),
    8: (255, 228, 196),
    9: (255, 105, 180),
    10: (165, 42, 42),
    11: (107, 142, 35),
    12: (160, 82, 45),
    41: (220, 20, 60),
}

_STA_X, _STA_Y = 300, 100          # Tracking.cc:840
_SCALE = 6.0                       # Tracking.cc:841


def _rect(img, x0, y0, x1, y1, color, fill=False):
    h, w = img.shape[:2]
    x0c, x1c = np.clip([x0, x1], 0, w - 1)
    y0c, y1c = np.clip([y0, y1], 0, h - 1)
    if x0c > x1c or y0c > y1c:
        return
    if fill:
        img[y0c:y1c + 1, x0c:x1c + 1] = color
        return
    img[y0c, x0c:x1c + 1] = color
    img[y1c, x0c:x1c + 1] = color
    img[y0c:y1c + 1, x0c] = color
    img[y0c:y1c + 1, x1c] = color


def _disc(img, x, y, r, color):
    h, w = img.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return
    yy, xx = np.ogrid[max(y - r, 0):min(y + r + 1, h),
                      max(x - r, 0):min(x + r + 1, w)]
    img[max(y - r, 0):min(y + r + 1, h),
        max(x - r, 0):min(x + r + 1, w)][
        (yy - y) ** 2 + (xx - x) ** 2 <= r * r] = color


def draw_frame(imtraj: np.ndarray, cam_T_wc: np.ndarray,
               obj_centres, obj_labels) -> None:
    """Draw one frame onto the caller's (H, W, 3) uint8 BGR canvas.

    ``cam_T_wc``: camera-to-world pose (the reference uses
    ``toInvMatrix(mTcw)``, Tracking.cc:842).  ``obj_centres``: iterable
    of world 3D object centres (vObjCentre3D); ``obj_labels``: their
    tracking labels (nModLabel)."""
    if imtraj is None or imtraj.ndim != 3 or imtraj.shape[2] != 3:
        return
    pos = np.asarray(cam_T_wc, np.float64)[:3, 3]
    x = int(pos[0] * _SCALE) + _STA_X
    y = int(pos[2] * _SCALE) + _STA_Y
    _rect(imtraj, x, y, x + 5, y + 5, (255, 0, 0))       # red square, :846
    _rect(imtraj, 10, 30, 550, 60, (0, 0, 0), fill=True)  # header band

    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the trajectory canvas (System.track_rgbd(traj=...)) needs "
            "OpenCV (the cv2 package) for its header text") from e
    cv2.putText(imtraj, "Camera Trajectory (RED SQUARE)", (10, 30),
                cv2.FONT_HERSHEY_COMPLEX, 0.6, (255, 255, 255), 1)
    cv2.putText(
        imtraj,
        "x = %02fm y = %02fm z = %02fm" % (pos[0], pos[1], pos[2]),
        (10, 50), cv2.FONT_HERSHEY_COMPLEX, 0.6, (255, 255, 255), 1,
    )
    cv2.putText(imtraj, "Object Trajectories (COLORED CIRCLES)",
                (10, 70), cv2.FONT_HERSHEY_COMPLEX, 0.6,
                (255, 255, 255), 1)

    for centre, label in zip(obj_centres, obj_labels):
        c = np.asarray(centre, np.float64).reshape(-1)
        if c.size < 3 or (c[0] == 0 and c[2] == 0):      # :857
            continue
        color = _LABEL_BGR.get(int(label))
        if color is None:
            continue
        _disc(imtraj, int(c[0] * _SCALE) + _STA_X,
              int(c[2] * _SCALE) + _STA_Y, 2, color)
