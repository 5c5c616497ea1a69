"""Record/replay differential: GPU step outputs against the CPU.

record mode (on the GPU): run the bench-config chained loop, recording
every frame-step's exact device inputs (state, packed bundle, GT tables,
PRNG key) and output buffer to a pickle.

replay mode (CPU-pinned): rebuild the same chained step program on the
CPU, feed it the RECORDED inputs, and compare the output pose with the
recorded GPU output pose frame by frame.  The first frame with a
material pose delta isolates a divergent on-device computation; if all
frames agree, a trajectory divergence lives in host-side state
evolution.

    python examples/replay_diff.py record rec.pkl
    SDPL_PIN_CPU=1 python examples/replay_diff.py replay rec.pkl
"""
import os
import pickle
import sys
import time

if os.environ.get("SDPL_PIN_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from synthetic import SynthConfig, SynthSequence, synth_settings  # noqa: E402

N_FRAMES = int(os.environ.get("SDPL_REPLAY_FRAMES", "53"))


def _settings():
    cfg = SynthConfig(
        n_frames=N_FRAMES + 1, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=0.2,
    )
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.fx, settings.fy = cfg.fx, cfg.fy
    settings.cx, settings.cy = cfg.cx, cfg.cy
    settings.width, settings.height = cfg.width, cfg.height
    settings.max_track_point_bg = 1200
    settings.max_track_point_obj = 800
    settings.max_static_lines = 400
    settings.max_objects = 8
    settings.th_depth_bg = 40.0
    settings.th_depth_obj = 25.0
    settings.min_object_points = 150
    settings.use_sample_fea = 0
    settings.chained_tracking = True
    settings.run_local_ba = False
    return seq, settings


def _run(seq, settings, record):
    import jax
    from sdpl_slam_tpu.models.system import System
    from sdpl_slam_tpu.models import chained as _ch

    records = []
    orig = _ch.ChainedDriver._chained_fn

    def patched(self):
        fn = orig(self)

        def wrapped(state, buf, gtp, gtc, key):
            rec = dict(
                state=jax.device_get(state),
                buf=np.array(buf), gtp=np.array(gtp),
                gtc=np.array(gtc), key=np.array(key),
            )
            new_state, out = fn(state, buf, gtp, gtc, key)
            rec["out"] = np.array(out)      # blocks: serializes pipeline
            records.append(rec)
            return new_state, out

        return wrapped

    _ch.ChainedDriver._chained_fn = patched
    try:
        system = System(settings, verbose=False)
        n = seq.n_frames - 1
        for t in range(n):
            f = seq.frame(t)
            nxt = seq.frame(t + 1) if t + 1 < n else None
            nxt2 = seq.frame(t + 2) if t + 2 < n else None
            system.track_rgbd(
                f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                t * 0.1, n + 1,
                next_image=None if nxt is None else nxt.gray,
                next_image2=None if nxt2 is None else nxt2.gray,
            )
            if t % 10 == 0:
                print("frame %d" % t, file=sys.stderr, flush=True)
        system.tracker.flush()
    finally:
        _ch.ChainedDriver._chained_fn = orig
    return system, records


def main():
    mode, path = sys.argv[1], sys.argv[2]
    seq, settings = _settings()

    if mode == "record":
        import jax
        system, records = _run(seq, settings, True)
        drv = system.tracker._res
        with open(path, "wb") as fh:
            pickle.dump(dict(records=records, caps=drv.caps), fh)
        print("recorded %d frames on %s" %
              (len(records), jax.devices()[0].platform))
        return

    # ---- replay ----
    import jax
    from sdpl_slam_tpu.models.system import System

    with open(path, "rb") as fh:
        data = pickle.load(fh)
    records = data["records"]

    # build the chained program on this backend by running 3 real frames
    system = System(settings, verbose=False)
    n_boot = 3
    for t in range(n_boot):
        f = seq.frame(t)
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, seq.n_frames + 1,
            next_image=seq.frame(t + 1).gray,
            next_image2=seq.frame(t + 2).gray,
        )
    drv = system.tracker._res
    drv.drain_all()
    fn = drv._chained_fn()
    state_t = type(drv.state)

    import jax.numpy as jnp
    from sdpl_slam_tpu.models.resident import unpack_out

    def pose_of(buf):
        return unpack_out(np.asarray(buf), data["caps"])["pose"]

    print("frame  d_pose_max      rot_delta_deg")
    for i, rec in enumerate(records):
        st = state_t(*[jnp.asarray(x) for x in rec["state"]])
        _, out = fn(st, jnp.asarray(rec["buf"]), jnp.asarray(rec["gtp"]),
                    jnp.asarray(rec["gtc"]),
                    jnp.asarray(rec["key"], dtype=jnp.uint32))
        out = np.array(out)
        p_cpu = pose_of(out).astype(np.float64)
        p_rec = pose_of(rec["out"]).astype(np.float64)
        d = float(np.max(np.abs(out - rec["out"])))
        E = p_cpu[:3, :3].T @ p_rec[:3, :3]
        c = np.clip((np.trace(E) - 1) / 2, -1, 1)
        rd = float(np.degrees(np.arccos(c)))
        flag = "  <<<" if rd > 0.05 else ""
        print("%5d  %.6e  %.5f%s" % (i, d, rd, flag), flush=True)


if __name__ == "__main__":
    main()
