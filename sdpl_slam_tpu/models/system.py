"""System facade: the reference's public API surface
(/root/reference/include/System.h:41-52, src/System.cc:22-64).

``System(settings_file, sensor).track_rgbd(...)`` + ``save_results(dir)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from ..io import writers
from ..utils import metrics
from ..utils.config import RGBD, Settings, load_settings
from .tracking import Tracking

BANNER = (
    " ----------------------------------------------------------------------------\n"
    "| SDPL-SLAM in JAX: a dynamic point-line SLAM framework.                     |\n"
    "| Re-designed from scratch in JAX/XLA with the capabilities of SDPL-SLAM.    |\n"
    " ----------------------------------------------------------------------------"
)


class System:
    def __init__(self, settings: str | Path | Settings, sensor: int = RGBD,
                 verbose: bool = True):
        if verbose:
            print(BANNER)
        if isinstance(settings, (str, Path)):
            settings = load_settings(settings)
        # accelerator backends get the persistent compile cache (a second
        # process skips the compiles; sdpl_slam_tpu.__init__ doc)
        import sdpl_slam_tpu as _pkg

        _pkg.maybe_enable_persistent_cache()
        self.settings = settings
        self.sensor = sensor
        if sensor != RGBD:
            raise ValueError("only the RGBD sensor mode is implemented "
                             "(reference guards identically, System.cc:55)")
        self.tracker = Tracking(settings)

    @property
    def map(self):
        # any consumer of the map forces completion of the in-flight
        # pipelined frame first, so observed state is always consistent
        self.tracker.flush()
        return self.tracker.map

    def track_rgbd(
        self,
        im: np.ndarray,
        depthmap: np.ndarray,
        flowmap: np.ndarray,
        masksem: np.ndarray,
        gt_pose: np.ndarray,
        obj_poses_gt: List[np.ndarray],
        timestamp: float,
        n_images: int,
        line_detections: Optional[np.ndarray] = None,
        point_detections: Optional[np.ndarray] = None,
        next_image: Optional[np.ndarray] = None,
        next_image2: Optional[np.ndarray] = None,
        traj: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Track one RGB-D frame; returns estimated T_cw.  Mirrors
        ``System::TrackRGBD`` (System.cc:51-64).
        ``traj``: optional caller-owned (H, W, 3) uint8 BGR canvas — the
        reference's ``imTraj`` (Tracking.h:67-69): for KITTI data the
        bird's-eye camera square + object-centre circles are drawn onto
        it in place per frame (Tracking.cc:836-907; here from the latest
        DRAINED map row — the pipelined/chained paths lag 1-2 frames).
        The reference's imshow windows are not replicated (headless).
        ``next_image``: optional prefetched image of frame t+1 -- its
        feature detectors run during this frame's solve, taking them off
        the per-frame critical path.  ``next_image2`` (frame t+2) lets
        the chained loop dispatch detectors TWO frames ahead, so a
        detector result queued behind the previous step still lands
        before the frame that needs it."""

        def to_gray(img):
            if img.ndim != 3:
                return img
            # cvtColor luma weights with the Camera.RGB channel-order flag
            # (Tracking::GrabImageRGBD, /root/reference/src/
            # Tracking.cc:224-237): RGB -> [.299, .587, .114], BGR reversed
            wts = np.array([0.299, 0.587, 0.114], np.float32)
            if not self.settings.rgb:
                wts = wts[::-1]
            return (img.astype(np.float32) @ wts).round().astype(np.uint8)

        import jax

        with jax.profiler.StepTraceAnnotation(
            "frame", step_num=self.tracker.f_id
        ):
            pose = self.tracker.grab_rgbd(
                to_gray(im), depthmap, flowmap, masksem, gt_pose,
                obj_poses_gt, timestamp, n_images,
                line_detections=line_detections,
                point_detections=point_detections,
                next_gray=None if next_image is None else to_gray(next_image),
                next_gray2=(None if next_image2 is None
                            else to_gray(next_image2)),
            )
        # trajectory canvas (KITTI only, like the reference's
        # mTestData==KITTI gate at Tracking.cc:836)
        if (traj is not None and self.settings.choose_data == 2
                and self.map.n_frames > 0):
            from ..utils import traj_canvas

            centres, labels = [], []
            if self.map.rigid_centres:       # one entry per frame PAIR
                centres = self.map.rigid_centres[-1][1:]
                labels = self.map.rm_labels[-1][1:]
            traj_canvas.draw_frame(
                traj, self.map.camera_poses[-1], centres, labels
            )
        return pose

    def save_checkpoint(self, path: str | Path) -> None:
        """Persist the full mid-run state (map history + tracker state) so a
        long sequence can resume.  The reference has no checkpointing
        (SURVEY.md section 5); this is new capability."""
        import pickle

        t = self.tracker
        t.flush()
        t.sync_host_state()
        blob = dict(
            f_id=t.f_id, max_id=t.max_id, velocity=t.velocity,
            origin_inv=t.origin_inv, last=t.last, last_meta=t.last_meta,
            last_mask=t.last_mask_np, last_flow=t.last_flow_np,
            oline_label=getattr(t, "_oline_label", None),
        )
        with open(path, "wb") as f:
            pickle.dump({"tracker": blob, "map": self.map}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)

    def load_checkpoint(self, path: str | Path) -> None:
        import pickle

        with open(path, "rb") as f:
            blob = pickle.load(f)
        t = self.tracker
        tr = blob["tracker"]
        t.f_id = tr["f_id"]
        t.max_id = tr["max_id"]
        t.velocity = tr["velocity"]
        t.origin_inv = tr["origin_inv"]
        t.last = tr["last"]
        t.last_meta = tr["last_meta"]
        t.last_mask_np = tr["last_mask"]
        t.last_flow_np = tr["last_flow"]
        if tr["oline_label"] is not None:
            t._oline_label = tr["oline_label"]
        t.map = blob["map"]

    def save_results(self, out_dir: str | Path, plots: bool = False) -> None:
        """Write the 7 result txt files + timing summary
        (System::SaveResults, System.cc:66-244), the Metrix_error.txt
        appends, tracklet histograms, and (optionally) the PlotMetricError
        PNG equivalents."""
        from ..utils import plotting

        print("Saving Results into TXT File...")
        writers.save_results(out_dir, self.map)
        print(writers.format_timing_summary(self.map))
        out = Path(out_dir)
        metrics.write_metric_error(self.map, out / "Metrix_error.txt")
        metrics.write_metric_error(
            self.map, out / "Metrix_error.txt", refined=True
        )
        plotting.write_tracklet_histograms(self.map, out)
        if plots:
            plotting.plot_metric_error(self.map, out)

    def metric_error(self, refined: bool = False) -> str:
        return metrics.metric_error_report(self.map, refined=refined)

    def velocity_error(self):
        return metrics.velocity_error(self.map)

    # --- device-level tracing (SURVEY.md section 5, tracing row).  The
    # reference exposes only wall-clock slot timing (also kept here, in
    # Map.frame_times); this adds XLA-level traces viewable in
    # TensorBoard/Perfetto. ---
    def start_profiler_trace(self, log_dir: str | Path) -> None:
        """Begin a ``jax.profiler`` trace (device + host timelines for
        every jitted stage) written under ``log_dir``."""
        import jax

        jax.profiler.start_trace(str(log_dir))
        self._tracing = True

    def stop_profiler_trace(self) -> None:
        import jax

        self.tracker.flush()
        jax.profiler.stop_trace()
        self._tracing = False
