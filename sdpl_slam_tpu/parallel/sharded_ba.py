"""Multi-chip global bundle adjustment via GSPMD edge-parallelism.

The full-sequence BA is the framework's scale axis (SURVEY.md section 5
"long context"): a KITTI sequence produces hundreds of thousands of
observation edges.  The edge stacks in :mod:`..solvers.batch_ba` are
embarrassingly parallel over the edge axis -- each edge gathers a handful
of vertices, computes a tiny residual/Jacobian, and scatter-adds into the
(small, replicated) variable vector.  Sharding recipe:

 * mesh axis ``"edge"`` over all devices;
 * every edge array (index, measurement, validity) sharded along axis 0;
 * vertex/state arrays replicated; the scatter-adds inside the CG
   Hessian-vector product become ``psum``-style collectives inserted by
   GSPMD, riding the device interconnect (NVLink between GPUs).

This scales the dominant cost (per-edge linearization + HVP streams) with
chip count while keeping the reduced variable state coherent.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import batch_ba as bb

# BAGraph fields sharded along their leading (edge) axis; everything else
# (vertex initializations, scalars) is replicated.
_EDGE_FIELDS = {
    "odo_i", "odo_j", "odo_meas", "odo_valid",
    "smo_i", "smo_j", "smo_valid",
    "sp_cam", "sp_pt", "sp_meas", "sp_valid",
    "sl_cam", "sl_line", "sl_meas", "sl_valid",
    "dp_cam", "dp_pt", "dp_meas", "dp_valid",
    "tern_prev", "tern_cur", "tern_mot", "tern_valid",
    "dl_cam", "dl_line", "dl_meas", "dl_valid",
    "ltern_prev", "ltern_cur", "ltern_mot", "ltern_valid",
}


def make_mesh(n_devices: Optional[int] = None, axis: str = "edge") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _pad_to_multiple(x: jnp.ndarray, mult: int):
    n = x.shape[0]
    rem = (-n) % mult
    if rem == 0:
        return x
    pad = jnp.zeros((rem,) + x.shape[1:], x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def shard_graph(graph: bb.BAGraph, mesh: Mesh, axis: str = "edge"):
    """Place edge arrays sharded over the mesh, the rest replicated.
    Edge arrays are padded (with invalid entries) to a multiple of the mesh
    size."""
    n = mesh.devices.size
    edge_spec = NamedSharding(mesh, P(axis))
    repl_spec = NamedSharding(mesh, P())
    out = {}
    for name, val in graph._asdict().items():
        if name in _EDGE_FIELDS:
            val = _pad_to_multiple(val, n)
            out[name] = jax.device_put(val, edge_spec)
        else:
            out[name] = jax.device_put(val, repl_spec)
    return bb.BAGraph(**out)


# (edge-id field, frame-locality sort key field) per edge family: sorting
# edges by the frame (or frame-ordered vertex id) they touch makes a
# contiguous edge shard reference a contiguous variable range, so the
# partitioned variable layout below keeps most gathers/scatter-adds local
_EDGE_SORT_KEYS = {
    "odo": ("odo_i", ("odo_i", "odo_j", "odo_meas", "odo_valid")),
    "smo": ("smo_i", ("smo_i", "smo_j", "smo_valid")),
    "sp": ("sp_cam", ("sp_cam", "sp_pt", "sp_meas", "sp_valid")),
    "sl": ("sl_cam", ("sl_cam", "sl_line", "sl_meas", "sl_valid")),
    "dp": ("dp_cam", ("dp_cam", "dp_pt", "dp_meas", "dp_valid")),
    "tern": ("tern_mot", ("tern_prev", "tern_cur", "tern_mot",
                          "tern_valid")),
    "dl": ("dl_cam", ("dl_cam", "dl_line", "dl_meas", "dl_valid")),
    "ltern": ("ltern_mot", ("ltern_prev", "ltern_cur", "ltern_mot",
                            "ltern_valid")),
}

# variable arrays sharded along their leading axis in partitioned mode
# (frame blocks for poses/motions; id blocks for structure -- the builder
# assigns ids in frame order, so blocks are frame-local)
_VAR_FIELDS = {
    "cam_T0", "cam_valid", "mot_T0", "mot_valid",
    "Xs0", "Xs_valid", "Ls_U0", "Ls_w0", "Ls_valid",
    "Xd0", "Xd_valid", "Ld_U0", "Ld_w0", "Ld_valid",
}


def shard_graph_partitioned(graph: bb.BAGraph, mesh: Mesh,
                            axis: str = "edge"):
    """Frame-range partitioning (SURVEY 7.3): edge arrays are SORTED by
    the frame they touch and sharded in contiguous blocks; variable
    arrays are sharded along their leading axis instead of replicated,
    so variable memory scales with chip count.  GSPMD inserts the halo
    collectives for the (rare, block-boundary) cross-shard references --
    ternary motion edges touching the previous frame's dynamic points
    are the main source (Optimizer.cc:4763-4813).

    Step results are identical to the replicated layout (the graph is a
    permutation of the same edge set; reductions are order-fixed by the
    segment ids)."""
    import numpy as np_

    n = mesh.devices.size
    edge_spec = NamedSharding(mesh, P(axis))
    repl_spec = NamedSharding(mesh, P())
    vals = graph._asdict()
    out = dict(vals)
    for fam, (keyf, fields) in _EDGE_SORT_KEYS.items():
        key = np_.asarray(vals[keyf])
        validf = fields[-1]
        valid = np_.asarray(vals[validf]).astype(bool)
        order = np_.argsort(
            np_.where(valid, key, np_.iinfo(np_.int64).max), kind="stable"
        )
        for f in fields:
            out[f] = np_.asarray(vals[f])[order]
    result = {}
    edge_fields = {f for _, fs in _EDGE_SORT_KEYS.values() for f in fs}
    for name, val in out.items():
        if name in edge_fields:
            val = _pad_to_multiple(jnp.asarray(val), n)
            result[name] = jax.device_put(val, edge_spec)
        elif name in _VAR_FIELDS:
            # NOTE: variable axes are padded only if needed; GSPMD
            # accepts uneven shards but padding keeps layouts simple
            v = jnp.asarray(val)
            if v.shape[0] % n == 0:
                result[name] = jax.device_put(v, edge_spec)
            else:
                result[name] = jax.device_put(v, repl_spec)
        else:
            result[name] = jax.device_put(jnp.asarray(val), repl_spec)
    return bb.BAGraph(**result)


def state_from_graph(graph: bb.BAGraph) -> bb.BAState:
    """Initial state aliasing the graph's (possibly sharded) vertex
    initializations."""
    return bb.BAState(
        cam_T=graph.cam_T0, mot_T=graph.mot_T0,
        Xs=graph.Xs0, Ls_U=graph.Ls_U0, Ls_w=graph.Ls_w0,
        Xd=graph.Xd0, Ld_U=graph.Ld_U0, Ld_w=graph.Ld_w0,
    )


def sharded_ba_step(graph: bb.BAGraph, state: bb.BAState, w: bb.BAWeights,
                    lam, mesh: Mesh, cg_iters: int = 10,
                    reduce_dtype=None):
    """One damped-GN BA step with the graph sharded over the mesh.  GSPMD
    propagates the edge sharding through linearization and inserts the
    reduction collectives for the scatter-adds.  ``reduce_dtype``
    (``ba_dtype: "mixed"``) runs the CG recurrences and the psum'd inner
    products in f64 while the sharded HVP stays f32 — the cross-chip
    reductions are exactly where long-sequence cancellation bites."""
    step = jax.jit(
        bb.ba_gn_step, static_argnames=("cg_iters", "w", "reduce_dtype"),
    )
    return step(graph, state, w, lam, cg_iters=cg_iters,
                reduce_dtype=reduce_dtype)


def variable_bytes_per_device(graph: bb.BAGraph) -> int:
    """Per-device bytes held by the VARIABLE arrays (the long-sequence
    memory axis, SURVEY 7.3): max over addressable shards.  Replicated
    layouts pay the full array on every chip; the partitioned layout
    shrinks this ~linearly with mesh size."""
    total = 0
    for name in _VAR_FIELDS:
        v = getattr(graph, name)
        shards = getattr(v, "addressable_shards", None)
        if shards:
            per_dev = {}
            for s in shards:
                d = s.device.id
                per_dev[d] = per_dev.get(d, 0) + s.data.nbytes
            total += max(per_dev.values())
        else:
            total += np.asarray(v).nbytes
    return total


def run_sharded_ba(graph: bb.BAGraph, w: bb.BAWeights, mesh: Mesh,
                   max_iters: int = 10, cg_iters: int = 20,
                   partitioned: bool = False, reduce_dtype=None):
    """LM loop over the sharded graph (full-sequence BA across chips).
    ``partitioned=True`` uses the frame-blocked layout with sharded
    variables (memory scales down with chip count; GSPMD inserts halo
    collectives for block-boundary ternary edges)."""
    graph = (shard_graph_partitioned if partitioned else shard_graph)(
        graph, mesh
    )
    state = bb.BAState(
        cam_T=graph.cam_T0, mot_T=graph.mot_T0,
        Xs=graph.Xs0, Ls_U=graph.Ls_U0, Ls_w=graph.Ls_w0,
        Xd=graph.Xd0, Ld_U=graph.Ld_U0, Ld_w=graph.Ld_w0,
    )
    cost_fn = jax.jit(bb._cost_only, static_argnames=("w",))
    retract = jax.jit(bb._retract)
    lam = jnp.asarray(1e-5, jnp.float32)
    nu = 2.0
    cost = float(cost_fn(graph, state, w))
    for _ in range(max_iters):
        d, _, gain_den = sharded_ba_step(
            graph, state, w, lam, mesh, cg_iters=cg_iters,
            reduce_dtype=reduce_dtype,
        )
        new_state = retract(state, d)
        new_cost = float(cost_fn(graph, new_state, w))
        rho = (cost - new_cost) / max(float(gain_den), 1e-20)
        if np.isfinite(new_cost) and rho > 0:
            state, cost = new_state, new_cost
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
        else:
            lam = lam * nu
            nu *= 2.0
    return state, cost
