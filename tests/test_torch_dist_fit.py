"""The training half of ``vrt_torch.dist`` against ``vrt.dist``: the
collectives' gradients, ``exchange_halos``' backward, the data-parallel
loss, gradient and step (``make_loss_and_grad_dp``, ``make_fit_step_dp``),
the slab fit steps (``make_slab_fit_step``, ``make_slab_fit_step_crossed``)
and ``vrt_torch.apps.scaling``.

The port's ranks are gloo processes on the CPU (``spawn_world``), one world
per group of cases; ``vrt`` runs in this process on the 8 virtual CPU
devices of tests/conftest.py.  Inputs come from ``default_rng`` with a
seed.  On the CPU the port runs the plain versions of its kernels: the
slab resolve's backward is its closed form
(``brick.resolve_slab_backward_reference``), into the planes (the default
table) or, on the first design's packed table, into the table and through
the table's pack to the planes; the two designs give the same loss and
gradients.  The gates: losses to rtol 1e-5 (1e-4 over two steps and
for the scaling app's rounded rows), gradients and updates through
``test_torch_fit.assert_grads_close`` (cosine 1 - 1e-6, largest difference
1e-4 of the largest |value|): XLA's CPU backend contracts sums into FMAs
that eager PyTorch rounds apart, and the ranks sum in another order than a
single process.  The halo exchange's backward only copies and adds once a
plane, so its gradient equals ``vrt``'s VJP bit for bit.

``tests/fixtures/slab_fit_r5_slab4_12x12.npz`` is ``vrt``'s loss and updated
planes of one ``make_slab_fit_step`` (SGD at 1e-2, zero targets, the 12x12
camera of tests/test_brick.py) on ``_volume()`` over 4 slabs, and the
gradient of that step's loss in the planes (the step's own body,
``_vrt_slab_grad``); ``python -m tests.test_torch_dist_fit`` rewrites it.
At SGD's 1e-2 an update (at most ~3e-6) is a few ulp of planes of ~50, so
the gradients are compared beside the updated planes.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests import torch_dist_workers as workers
from tests.test_torch_fit import assert_grads_close
from tests.test_torch_host import scene_fields
from vrt.core import quat as vvq
from vrt.dist import brick as vbrick
from vrt.dist import sharding as vsharding
from vrt.dist import slab_render as vslab
from vrt.dist.mesh import make_render_mesh as vmesh
from vrt.render.camera import camera_rays as vcamera_rays
from vrt.render.gpuscene import RenderMode as VMode
from vrt.volume import sdf as VS
from vrt.volume.volume import VoxelVolume as VVolume
from vrt_torch.dist import brick, mesh

torch.set_num_threads(2)
TIMEOUT = 300.0
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "slab_fit_r5_slab4_12x12.npz")
LOSS_RTOL = 1e-5


def _volume():
    """tests/test_brick.py's volume: a sphere plus a box at resolution 5
    (33^3)."""
    csg = VS.CSG(shape=VS.Sphere(radius=55.0))
    csg.add_child(VS.Box(extends=(70.0, 25.0, 25.0),
                         position=np.array([0.0, 0.0, 40.0], np.float32)),
                  VS.ADD)
    return VVolume.from_generator(csg, 5, 100.0)


def _np_fields(slabs):
    return {f: np.asarray(getattr(slabs, f)) for f in brick._FIELDS}


# ---- the collectives and the halo exchange ----------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_collective_gradients_are_their_closed_forms(world):
    """The all-gather's gradient is the sum over the ranks of the
    cotangent's rows of this rank, the sum's the sum of the cotangents, and
    the loss's sum hands its cotangent through unchanged; without a graph
    the plain collectives run.  Integer-valued floats: every sum exact."""
    rng = np.random.default_rng(world)
    xs = rng.integers(-4, 5, size=(world, 3, 2)).astype(np.float32)
    cots = {"gather": rng.integers(-3, 4, size=(world, 3 * world, 2)
                                   ).astype(np.float32),
            "sum": rng.integers(-3, 4, size=(world, 3, 2)).astype(np.float32),
            "loss": rng.integers(1, 5, size=world).astype(np.float32)}
    out = mesh.spawn_world(workers.collective_grad_world, world,
                           args=(xs, cots), timeout=TIMEOUT)
    gather_sum = cots["gather"].sum(axis=0)
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["gather"],
                                      gather_sum[3 * r:3 * (r + 1)])
        np.testing.assert_array_equal(got["sum"], cots["sum"].sum(axis=0))
        np.testing.assert_array_equal(got["loss_grad"],
                                      cots["loss"][r] * 2 * xs[r])
        assert got["loss"] == float((xs * xs).sum())
        assert not got["plain_graph"]
        # forward: 2 gathers, 2 sums (the loss's among them); backward: the
        # gather's and the sum's all-reduces
        assert got["stats"]["all_gather"] == 2
        assert got["stats"]["all_reduce"] == 4


def test_exchange_halos_gradient_is_vrt_vjp():
    """``jax.vjp`` of ``vrt.dist.brick.exchange_halos`` under ``shard_map``
    over 4 devices, random cotangents on ``_volume()``'s slabs: the port's
    gradient over 4 gloo ranks is the same bit for bit (the halo planes'
    cotangents added once into their owners' planes, the overwritten slots'
    zeroed, the edge ranks' outer planes kept)."""
    vol = _volume()
    slabs = vbrick.shard_volume(vol, 4)
    cots = np.random.default_rng(7).normal(size=slabs.sdf.shape
                                           ).astype(np.float32)

    @partial(jax.shard_map, mesh=vmesh(1, 4),
             in_specs=(P("model"), P("model")), out_specs=P("model"))
    def vjp(slabs, ct):
        slab = jax.tree.map(lambda x: x[0], slabs)

        def halo(sdf):
            import dataclasses

            return vbrick.exchange_halos(
                dataclasses.replace(slab, sdf=sdf), "model").sdf

        _, back = jax.vjp(halo, slab.sdf)
        return back(ct[0])[0][None]

    want = np.asarray(jax.jit(vjp)(slabs, jnp.asarray(cots)))
    out = mesh.spawn_world(workers.halo_grad_world, 4,
                           args=(_np_fields(slabs), "octree", cots),
                           timeout=TIMEOUT)
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got, want[r])
    span, hl = cots.shape[1], brick.HALO
    # the gradient moved: an interior rank's owned plane next to its left
    # boundary holds its left neighbour's right-halo cotangent
    assert not np.array_equal(want[1, hl + 1], cots[1, hl + 1])
    assert not np.array_equal(want[1, span - 2 * hl - 1],
                              cots[1, span - 2 * hl - 1])


@pytest.mark.parametrize("table", brick.TABLES)
@pytest.mark.parametrize("s_count", [2, 4])
def test_resolve_slab_function_matches_autograd(s_count, table):
    """``ResolveSlab`` on CPU tensors (``resolve_slab_hits`` forward, the
    closed form ``resolve_slab_backward_reference`` over the slab's
    ``resolve_table``: into the planes, or into the first design's packed
    table whose gradient autograd carries to the planes through the pack)
    against autograd of ``resolve_slab_hits`` in the planes and the rays,
    every shard of ``_volume()``, random cotangents on the lanes the shard
    owns (as the tracer's owner sum gives them): gradients within 1e-5 of
    the largest |value|, t and the normal equal."""
    import dataclasses

    from vrt_torch.core import quat as vq
    from vrt_torch.dist.slab_render import SlabTracer, default_fit_scene
    from vrt_torch.kernels.resolve import ResolveSlab
    from vrt_torch.volume import sdf as TS
    from vrt_torch.volume.volume import VoxelVolume as TVolume

    csg = TS.CSG(shape=TS.Sphere(radius=55.0))
    csg.add_child(TS.Box(extends=(70.0, 25.0, 25.0),
                         position=np.array([0.0, 0.0, 40.0], np.float32)),
                  TS.ADD)
    vol = TVolume.from_generator(csg, 5, 100.0)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(0, 45, -30)),
                       np.float32)
    scene = default_fit_scene(vol.n_voxels, vol.cell_size, vol.extends,
                              light, device="cpu")
    rng = np.random.default_rng(s_count)
    n = 2048
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-d * rng.uniform(150.0, 320.0, size=(n, 1))
         + rng.normal(scale=30.0, size=(n, 3))).astype(np.float32)
    slabs = brick.shard_volume(vol, s_count)
    owned_lanes = 0
    for s in range(s_count):
        slab = slabs.local(s, "cpu")
        grads = []
        for fn in ("function", "autograd"):
            planes = slab.sdf.clone().requires_grad_(True)
            sl = dataclasses.replace(slab, sdf=planes, table=table)
            o_w = torch.from_numpy(o).requires_grad_(True)
            d_w = torch.from_numpy(d).requires_grad_(True)
            ob, db = SlabTracer(sl, None)._object_rays(scene, o_w, d_w)
            if fn == "function":
                hit = brick.march_volume_slab(sl, ob, db,
                                              torch.full((n,), 1e4))
                owned = (hit.hit & (hit.cell[:, 0] >= slab.cell_lo)
                         & (hit.cell[:, 0] < slab.cell_hi))
                gen = torch.Generator().manual_seed(s)
                g_t = torch.randn(n, generator=gen) * owned
                g_n = torch.randn((n, 3), generator=gen) * owned[:, None]
                inst = torch.where(hit.hit, 0, -1).to(torch.int32)
                t, normal, _ = ResolveSlab.apply(
                    o_w, d_w, sl.resolve_table, scene, sl, hit, inst)
            else:
                t, normal, _ = brick.resolve_slab_hits(sl, ob, db, hit)
            ((t * g_t).sum() + (normal * g_n).sum()).backward()
            grads.append((planes.grad, o_w.grad, d_w.grad,
                          t[owned].detach(), normal[owned].detach()))
        for name, a, b in zip(("planes", "g_o_w", "g_d_w"), grads[0],
                              grads[1]):
            scale = b.abs().max().item()
            assert scale > 0, name
            assert (a - b).abs().max().item() <= 1e-5 * scale, (s, name)
        for a, b in zip(grads[0][3:], grads[1][3:]):
            assert torch.equal(a, b)
        owned_lanes += int(owned.sum())
    assert owned_lanes > 500


# ---- the data-parallel fit --------------------------------------------------

_DP = {}


def _dp_inputs():
    """tests/test_dist.py's 16x16 coloured scene, its camera rays, zero
    targets, and the SDF and colours as the parameters."""
    if not _DP:
        from tests.test_dist import _scene

        vs = _scene(use_colors=True)
        o, d = vcamera_rays(vs.cam_pos, vs.cam_rot, vs.cam_fov, 16, 16)
        params = {"sdf": np.asarray(vs.volumes.sdf),
                  "voxel_colors": np.asarray(vs.voxel_colors)}
        _DP.update(vscene=vs, fields=scene_fields(vs), o=np.asarray(o),
                   d=np.asarray(d), targets=np.zeros((256, 3), np.float32),
                   params=params)
    return _DP


def _single_process_grad(inp):
    """The port's value and gradient of the summed loss in this process."""
    from vrt_torch.diff.fit import _value_and_grad, graft_and_rebuild
    from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
    from vrt_torch.render.renderer import tonemap, trace_radiance

    scene = scene_from_numpy(inp["fields"], device="cpu")
    o, d, targets = (torch.from_numpy(np.array(inp[k]))
                     for k in ("o", "d", "targets"))

    def loss_fn(p):
        s = graft_and_rebuild(scene, p)
        rgb = trace_radiance(s, o, d, 0, RenderMode())
        return torch.sum((tonemap(rgb) - targets) ** 2)

    return _value_and_grad(loss_fn, {k: torch.from_numpy(v)
                                     for k, v in inp["params"].items()})


@pytest.mark.parametrize("world", [2, 4])
def test_loss_and_grad_dp_matches_vrt(world):
    """``make_loss_and_grad_dp`` over ``world`` data ranks, interleaved and
    blocked: every rank's loss and gradients (SDF and colours) against
    ``vrt``'s over ``world`` virtual devices and against the port's
    single-process value and gradient of the same summed loss."""
    from vrt.diff.fit import graft_params, rebuild_accel

    inp = _dp_inputs()
    vs = inp["vscene"]
    vparams = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    scene_r = rebuild_accel(graft_params(vs, vparams))
    cases = [("sum", True), ("sum", False)]
    out = mesh.spawn_world(
        workers.dp_world, world,
        args=(inp["fields"], inp["params"], inp["o"], inp["d"],
              inp["targets"], {}, cases), timeout=TIMEOUT)
    single_loss, single_grads = _single_process_grad(inp)
    for i, (_, interleave) in enumerate(cases):
        fn = vsharding.make_loss_and_grad_dp(VMode(), vmesh(world, 1),
                                             interleave=interleave)
        vloss, vgrads = jax.jit(fn)(vparams, scene_r, jnp.asarray(inp["o"]),
                                    jnp.asarray(inp["d"]),
                                    jnp.asarray(inp["targets"]))
        for r, ranks in enumerate(out):
            loss, grads = ranks[i]
            tag = f"world {world} interleave {interleave} rank {r}"
            np.testing.assert_allclose(loss, float(vloss), rtol=LOSS_RTOL,
                                       err_msg=tag)
            np.testing.assert_allclose(loss, single_loss.item(),
                                       rtol=LOSS_RTOL, err_msg=tag)
            for k, g in grads.items():
                assert_grads_close(torch.from_numpy(g), vgrads[k],
                                   f"{tag} {k} vs vrt")
                assert_grads_close(torch.from_numpy(g),
                                   single_grads[k].numpy(),
                                   f"{tag} {k} vs one process")
                if r:
                    np.testing.assert_array_equal(g, out[0][i][1][k])


def test_fit_step_dp_tracks_vrt():
    """Two ``make_fit_step_dp`` steps (SGD at 1e-2) over a 2x2 mesh of gloo
    ranks against ``vrt``'s over a (2, 2) mesh: the losses to rtol 1e-4,
    descending, and each rank's updated parameters within the gates of the
    update."""
    inp = _dp_inputs()
    vs = inp["vscene"]
    optimizer = optax.sgd(1e-2)
    vparams = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    state = optimizer.init(vparams)
    step = vsharding.make_fit_step_dp(VMode(), vmesh(2, 2), optimizer)
    vlosses, p = [], vparams
    for _ in range(2):
        p, state, loss = step(p, state, vs, jnp.asarray(inp["o"]),
                              jnp.asarray(inp["d"]),
                              jnp.asarray(inp["targets"]))
        vlosses.append(float(loss))
    out = mesh.spawn_world(
        workers.dp_step_world, 4,
        args=((2, 2), inp["fields"], inp["params"], inp["o"], inp["d"],
              inp["targets"], 1e-2, 2), timeout=TIMEOUT)
    assert vlosses[1] < vlosses[0]
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["losses"], vlosses, rtol=1e-4)
        assert got["losses"][1] < got["losses"][0]
        for k, v0 in inp["params"].items():
            assert_grads_close(torch.from_numpy(got["params"][k] - v0),
                               np.asarray(p[k]) - v0, f"rank {r} {k}")


# ---- the slab fit steps -----------------------------------------------------

_SLAB = {}


def _slab_inputs():
    """tests/test_brick.py's slab fit: ``_volume()`` (33^3), the 12x12
    camera at (300, 0, 0), ``default_fit_scene`` lit along Euler
    (0, 45, -30), zero targets."""
    if not _SLAB:
        vol = _volume()
        o, d = vcamera_rays(jnp.asarray([300.0, 0.0, 0.0]),
                            jnp.asarray(vvq.from_euler_degrees(0.0, 180.0,
                                                               0.0)),
                            jnp.asarray(60.0), 12, 12)
        light = np.asarray(vvq.forward_vector(
            vvq.from_euler_degrees(0.0, 45.0, -30.0)), np.float32)
        scene = vslab.default_fit_scene(vol.n_voxels, vol.cell_size,
                                        vol.extends, light)
        _SLAB.update(vol=vol, vscene=scene, fields=scene_fields(scene),
                     o=np.asarray(o), d=np.asarray(d),
                     targets=np.zeros((144, 3), np.float32))
    return _SLAB


def _vrt_slab_step(s_count, optimizer, crossed=False):
    """``vrt``'s slab fit step on the slab inputs over ``s_count`` model
    shards (with ``crossed``, over a (2, s_count) mesh): (params0,
    params1, loss) with the stacked [S, span, N, N] planes."""
    inp = _slab_inputs()
    slabs = vbrick.shard_volume(inp["vol"], s_count)
    if crossed:
        step = vslab.make_slab_fit_step_crossed(vmesh(2, s_count), optimizer,
                                                inp["vscene"])
    else:
        step = vslab.make_slab_fit_step(vmesh(1, s_count), optimizer,
                                        inp["vscene"])
    params0 = slabs.sdf
    params1, _, loss = step(params0, optimizer.init(params0), slabs,
                            *(jnp.asarray(inp[k])
                              for k in ("o", "d", "targets")))
    return np.asarray(params0), np.asarray(params1), float(loss), slabs


def _vrt_slab_grad(s_count):
    """The loss and its gradient in the stacked planes of ``vrt``'s
    ``make_slab_fit_step`` over ``s_count`` shards: the step's own
    ``shard_map`` body (``vrt/dist/slab_render.py``), which hands the
    optimizer this gradient."""
    import dataclasses

    from vrt.render.renderer import tonemap, trace_radiance

    inp = _slab_inputs()
    slabs = vbrick.shard_volume(inp["vol"], s_count)
    axis, scene = "model", inp["vscene"]

    @jax.jit
    @partial(jax.shard_map, mesh=vmesh(1, s_count),
             in_specs=(P(axis),) * 5, out_specs=(P(axis), P()))
    def local_grad(params, slabs, o, d, targets):
        slab = jax.tree.map(lambda x: x[0], slabs)

        def loss_fn(sdf):
            s = vbrick.exchange_halos(dataclasses.replace(slab, sdf=sdf),
                                      axis)
            rgb = trace_radiance(scene, o, d, 0, VMode(),
                                 tracer=vslab.GatherSlabTracer(s, axis))
            img = tonemap(rgb)
            se = jnp.sum((img - targets) ** 2)
            n = jax.lax.psum(jnp.float32(img.size), axis)
            return jax.lax.psum(se, axis) / n

        loss, g = jax.value_and_grad(loss_fn)(params[0])
        return g[None], loss

    grad, loss = local_grad(slabs.sdf, slabs,
                            *(jnp.asarray(inp[k])
                              for k in ("o", "d", "targets")))
    return np.asarray(grad), float(loss)


def _port_slab_step(slabs, shape, optimizer, opt_args, crossed=False,
                    table="planes"):
    inp = _slab_inputs()
    return mesh.spawn_world(
        workers.slab_fit_world, shape[0] * shape[1],
        args=(shape, inp["fields"], _np_fields(slabs), inp["o"], inp["d"],
              inp["targets"], optimizer, opt_args, crossed, table),
        timeout=TIMEOUT)


def _stacked(out, key, like):
    """The ranks' ``key`` stacked by model index."""
    got = np.zeros_like(like)
    for g in out:
        got[g["model"]] = g[key]
    return got


def _assert_updates(out, params0, params1, loss, tag, grad=None):
    """Every rank's loss against ``loss``, and the ranks' updated planes,
    halo planes included, stacked by model index, against ``params1``
    within the gates of the update (one gate over every rank: a slab that
    no hit reaches has no update in either package); with ``grad``, the
    gradients the ranks' steps handed their optimizers against it."""
    for r, g in enumerate(out):
        np.testing.assert_allclose(g["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=f"{tag} rank {r}")
    got = _stacked(out, "params", params0)
    assert_grads_close(torch.from_numpy(got - params0), params1 - params0,
                       tag)
    for s in range(params0.shape[0]):
        if not (params1[s] - params0[s]).any():
            np.testing.assert_array_equal(got[s], params0[s])
    if grad is not None:
        assert_grads_close(torch.from_numpy(_stacked(out, "grad", grad)),
                           grad, f"{tag} gradient")


def test_slab_fit_step_sgd_over_4_ranks_matches_vrt():
    """One ``make_slab_fit_step`` with SGD at 1e-2 over 4 gloo ranks
    against ``vrt``'s over 4 devices (the fixture): the loss, every rank's
    updated planes, and updates on owned planes on both sides of an
    interior slab boundary (``test_boundary_gradients_flow_through_halos``'
    assertion: a neighbour's halo reads send their gradient home)."""
    with np.load(FIXTURE) as f:
        params1, loss, grad = f["params"], float(f["loss"]), f["grad"]
    inp = _slab_inputs()
    slabs = vbrick.shard_volume(inp["vol"], 4)
    params0 = np.asarray(slabs.sdf)
    out = _port_slab_step(slabs, (1, 4), "sgd", dict(learning_rate=1e-2))
    _assert_updates(out, params0, params1, loss, "sgd S=4", grad)
    delta = np.stack([np.abs(g["params"] - params0[g["model"]])
                      for g in out])
    assert (delta.reshape(4, -1).max(axis=1) > 0).sum() >= 2
    span, hl = params0.shape[1], brick.HALO
    last_owned = delta[:, span - 2 * hl - 1:span - hl - 1].reshape(4, -1)
    first_owned = delta[:, hl:2 * hl + 1].reshape(4, -1)
    assert any(last_owned[s].max() > 0 and first_owned[s + 1].max() > 0
               for s in range(3))


def test_slab_fit_step_adam_over_2_ranks_matches_vrt():
    """One ``make_slab_fit_step`` with Adam at 0.1 over 2 gloo ranks
    against ``vrt``'s with ``optax.adam(0.1)`` over 2 devices, both with
    eps 1e-3: Adam's first update is lr * g / (|g| + eps), which at the
    default eps of 1e-8 turns a rounding difference of 3e-12 in a gradient
    of 8e-10 (the largest is 3e-4) into 3e-5 of update; at 1e-3 the update
    follows the gradient's gates."""
    params0, params1, loss, slabs = _vrt_slab_step(
        2, optax.adam(0.1, eps=1e-3))
    out = _port_slab_step(slabs, (1, 2), "adam",
                          dict(learning_rate=0.1, eps=1e-3))
    _assert_updates(out, params0, params1, loss, "adam S=2")


def test_slab_fit_step_crossed_matches_vrt():
    """``make_slab_fit_step_crossed`` (SGD at 1e-2) over a 2x2 world of
    gloo ranks: the loss, summed over both axes, against ``vrt``'s crossed
    step over a (2, 2) mesh, and the updated planes (the gradient
    all-reduced over the data axis) against ``vrt``'s ``make_slab_fit_step``
    over 2 devices on the same rays, whose loss is the same function of the
    planes.  ``vrt``'s crossed update is not that loss's gradient: on
    these inputs it is 2.005 times the single-axis update in norm, at a
    cosine of 0.988 (part of its gradient is summed over the data axis
    twice, once by the transpose of the replicated planes' broadcast and
    once by its explicit psum), so the gradient of the loss is the
    reference here.  Both data ranks of a model index hold the same
    planes."""
    _, _, crossed_loss, _ = _vrt_slab_step(2, optax.sgd(1e-2), crossed=True)
    params0, params1, loss, slabs = _vrt_slab_step(2, optax.sgd(1e-2))
    grad, grad_loss = _vrt_slab_grad(2)
    np.testing.assert_allclose(crossed_loss, loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad_loss, loss, rtol=LOSS_RTOL)
    out = _port_slab_step(slabs, (2, 2), "sgd", dict(learning_rate=1e-2),
                          crossed=True)
    _assert_updates(out, params0, params1, crossed_loss, "crossed 2x2",
                    grad)
    np.testing.assert_array_equal(out[0]["params"], out[2]["params"])
    np.testing.assert_array_equal(out[1]["params"], out[3]["params"])


@pytest.mark.parametrize("crossed", [False, True],
                         ids=["single_axis", "crossed"])
def test_slab_fit_step_tables_agree(crossed):
    """``make_slab_fit_step`` over 4 gloo ranks (with ``crossed``,
    ``make_slab_fit_step_crossed`` over 2x2) on the slab inputs, SGD at
    1e-2, on both tables: the planes (the default) and the first design's
    packed corner table.  The same loss on every rank
    (rtol 1e-6), and the gradients the ranks' steps hand their optimizers,
    all ranks together, at 1 - cos < 1e-10 and within 1e-6 of the largest
    |g|: the two sum the same corner cotangents into the planes, one by
    ``index_add_`` and one through the pack's backward."""
    slabs = vbrick.shard_volume(_slab_inputs()["vol"], 2 if crossed else 4)
    out = {t: _port_slab_step(slabs, (2, 2) if crossed else (1, 4), "sgd",
                              dict(learning_rate=1e-2), crossed, t)
           for t in brick.TABLES}
    for r, (g, h) in enumerate(zip(out["planes"], out["packed"])):
        np.testing.assert_allclose(g["loss"], h["loss"], rtol=1e-6,
                                   err_msg=f"rank {r}")
    a, b = (np.concatenate([g["grad"].astype(np.float64).ravel()
                            for g in out[t]]) for t in ("planes", "packed"))
    assert np.abs(b).max() > 0
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert 1.0 - cos < 1e-10, 1.0 - cos
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_slab_fit_fixture_is_vrt_step():
    """The fixture is ``vrt``'s step: a fresh one may move the loss and the
    planes only by float rounding."""
    with np.load(FIXTURE) as f:
        want = {k: f[k] for k in f.files}
    got = write_fixture(None)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=1e-6)
    assert_grads_close(torch.from_numpy(got["grad"]), want["grad"], "grad",
                       cos_tol=1e-12, diff_tol=1e-6)
    assert np.abs(want["grad"]).max() > 0


def write_fixture(path=FIXTURE):
    """``vrt``'s ``make_slab_fit_step`` (SGD at 1e-2) on the slab inputs
    over 4 of the virtual devices: the loss, the updated stacked planes and
    the gradient (``_vrt_slab_grad``), saved to ``path`` unless it is
    None."""
    assert len(jax.devices()) >= 4
    _, params1, loss, _ = _vrt_slab_step(4, optax.sgd(1e-2))
    grad, grad_loss = _vrt_slab_grad(4)
    assert abs(grad_loss - loss) <= 1e-6 * abs(loss)
    out = dict(params=params1.astype(np.float32), loss=np.float32(loss),
               grad=grad.astype(np.float32))
    if path is not None:
        np.savez(path, **out)
    return out


# ---- the scaling app --------------------------------------------------------

def test_scaling_app_matches_vrt(tmp_path):
    """``python -m vrt_torch.apps.scaling --device cpu --res 4 --rays 64
    --steps 1 --shards 1 2`` against ``vrt.apps.scaling.run`` at the same
    arguments: every row and the summary carry ``vrt``'s keys, the losses
    agree to rtol 1e-4 (``vrt`` rounds them to 6 places) and the primary
    march steps of every shard are ``vrt``'s."""
    from vrt.apps import scaling as vscaling
    from vrt_torch.apps import scaling

    out = tmp_path / "scaling.jsonl"
    assert scaling.main(["--device", "cpu", "--res", "4", "--rays", "64",
                         "--steps", "1", "--shards", "1", "2", "--out",
                         str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    want_rows, want_summary = vscaling.run(4, 64, 1, [1, 2])
    assert len(rows) == len(want_rows) == 2
    for got, want in zip(rows, want_rows):
        assert set(want) <= set(got)
        assert got["model_shards"] == want["model_shards"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        assert got["march_steps_per_shard"] == want["march_steps_per_shard"]
        assert got["step_s"] > 0
    assert set(want_summary) <= set(summary)
    assert summary["metric"] == want_summary["metric"]
    assert summary["best_shards"] == 2 and summary["device"] == "cpu"


if __name__ == "__main__":
    # the virtual devices of tests/conftest.py (read when JAX first starts
    # its CPU backend, after this module's import)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
